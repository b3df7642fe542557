"""chip_smoke.py's own logic, on the CPU: it refuses to run without a GPU
(before any phase, with no result line), and its helpers compare bits."""

import json

import numpy as np
import pytest

import chip_smoke


def test_main_refuses_cpu_backend_before_any_phase(capsys, monkeypatch):
    ran = []
    monkeypatch.setattr(chip_smoke.Smoke, "env", lambda self: ran.append("env"))
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert ran == []
    assert "needs an NVIDIA GPU" in out.err
    for line in out.out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_unknown_phase_is_an_error():
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--phase", "nope"])
    assert e.value.code != 0


def test_bits_equal_is_bitwise():
    x = np.array([0.0, 1.0, np.nan])
    assert chip_smoke.bits_equal(x, x.copy())
    assert not chip_smoke.bits_equal(x, np.array([-0.0, 1.0, np.nan]))
    assert not chip_smoke.bits_equal(x, x[:2])
