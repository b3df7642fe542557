"""Light unit tests: mode parsing, CULiP log format, env-configured handle."""

import io
import sys

import numpy as np
import pytest

import ozimmu_tpu as oz
from ozimmu_tpu.types import ComputeMode
from ozimmu_tpu.utils.profiling import culip_timer


class TestComputeModeParse:
    def test_roundtrip_all(self):
        for ns in range(3, 19):
            m = ComputeMode.parse(f"fp64_int8_{ns}")
            assert m.is_int8 and m.num_split == ns
            assert ComputeMode.parse(m) is m
        assert ComputeMode.parse("dgemm") is ComputeMode.DGEMM
        assert ComputeMode.parse("sgemm") is ComputeMode.SGEMM
        assert ComputeMode.parse("fp64_int8_auto") is ComputeMode.FP64_INT8_AUTO

    def test_invalid_rejected(self):
        with pytest.raises(ValueError):
            ComputeMode.parse("fp64_int8_19")
        with pytest.raises(ValueError):
            ComputeMode.parse("bogus")


class TestCulip:
    def test_log_line_format(self, monkeypatch, capsys):
        monkeypatch.setenv("OZIMMU_ENABLE_CULIP_PROFILING", "1")
        with culip_timer("cublasDgemm_v2-NN-m1024-n1024-k1024"):
            pass
        out = capsys.readouterr().out
        assert out.startswith("[CULiP Result][cublasDgemm_v2-NN-m1024-n1024-k1024] ")
        assert out.strip().endswith("[ns]")

    def test_disabled_silent(self, monkeypatch, capsys):
        monkeypatch.delenv("OZIMMU_ENABLE_CULIP_PROFILING", raising=False)
        with culip_timer("x"):
            pass
        assert capsys.readouterr().out == ""


class TestHandleEnv:
    def test_thresholds_from_env(self, monkeypatch):
        monkeypatch.setenv("OZIMMU_INTERCEPT_THRESHOLD_M", "7")
        monkeypatch.setenv("OZIMMU_INTERCEPT_THRESHOLD_N", "11")
        monkeypatch.setenv("OZIMMU_INTERCEPT_THRESHOLD_K", "13")
        h = oz.create()
        assert (h.intercept_threshold_m, h.intercept_threshold_n,
                h.intercept_threshold_k) == (7, 11, 13)
        oz.destroy(h)

    def test_auto_threshold_env(self, monkeypatch):
        monkeypatch.setenv("OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD", "2.5")
        h = oz.create()
        assert h.avg_mantissa_loss_threshold == 2.5

    def test_warmup_compiles(self):
        # AOT warm-up parity (reallocate_working_memory semantics)
        h = oz.create()
        n = oz.reallocate_working_memory(
            h, [("N", "N", 32, 32, 32, "real", "fp64_int8_8")]
        )
        assert n >= 0


class TestCompileCache:
    def _record(self, monkeypatch):
        import jax

        calls = {}
        monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
        return calls

    def test_env_dir_is_honoured_and_nothing_else_set(self, monkeypatch, tmp_path):
        from ozimmu_tpu.utils.cache import enable_compile_cache

        calls = self._record(monkeypatch)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        assert calls == {}

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        import os

        from ozimmu_tpu.utils import cache

        calls = self._record(monkeypatch)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = cache.enable_compile_cache(min_compile_secs=2.0)
        root = os.path.dirname(os.path.dirname(os.path.abspath(oz.__file__)))
        assert got == os.path.join(root, ".jax_cache") == cache.DEFAULT_CACHE_DIR
        assert calls == {
            "jax_compilation_cache_dir": got,
            "jax_persistent_cache_min_compile_time_secs": 2.0,
        }
        # the same path every time: it is part of every cache entry's key
        assert cache.enable_compile_cache(min_compile_secs=2.0) == got


class TestMemoryBudget:
    class _Dev:
        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    def _devices(self, monkeypatch, stats):
        import jax

        monkeypatch.delenv("OZIMMU_HBM_BUDGET_MB", raising=False)
        monkeypatch.setattr(jax, "devices", lambda *a: [self._Dev(stats)])

    def test_budget_from_device_limit(self, monkeypatch):
        from ozimmu_tpu import schedule

        self._devices(monkeypatch, {"bytes_limit": 60 << 30, "bytes_in_use": 0})
        want = int((60 << 30) * schedule.HBM_BUDGET_FRACTION)
        assert schedule.hbm_budget_bytes() == want
        # 16384^3 ns=9 runs unchunked within an 80 GB card's JAX share
        assert schedule.auto_n_chunks(16384, 16384, 16384, 9) == 1

    def test_no_limit_uses_the_test_budget(self, monkeypatch):
        from ozimmu_tpu import schedule

        self._devices(monkeypatch, None)
        assert schedule.hbm_budget_bytes() == schedule.CPU_TEST_BUDGET_MB << 20

    def test_env_overrides_device_limit(self, monkeypatch):
        from ozimmu_tpu import schedule

        self._devices(monkeypatch, {"bytes_limit": 60 << 30})
        monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "123")
        assert schedule.hbm_budget_bytes() == 123 << 20
