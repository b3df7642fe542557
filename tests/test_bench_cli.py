"""Bench CLI smoke tests (CPU): CSV schema, timing helper, ci_test slice."""

import io
import sys

import numpy as np
import pytest

from ozimmu_tpu import bench_cli
from ozimmu_tpu.testing import effective_tflops, generate_input


class TestBenchCli:
    def _capture(self, fn, *args, **kw):
        buf = io.StringIO()
        old = sys.stdout
        sys.stdout = buf
        try:
            rc = fn(*args, **kw)
        finally:
            sys.stdout = old
        return rc, buf.getvalue()

    @pytest.mark.slow
    def test_sweep_csv_schema(self):
        rc, out = self._capture(
            bench_cli.main,
            ["urand01", "dgemm", "fp64_int8_8", "seq", "128", "128", "128",
             "--test-count", "2"],
        )
        assert rc == 0
        lines = [l for l in out.strip().splitlines() if l]
        header = lines[0].split(",")
        assert header == ["device", "gemm", "input", "mode", "opA", "opB",
                          "m", "n", "k", "residual", "max_relative", "tflops"]
        row = lines[1].split(",")
        assert float(row[9]) < 1e-15  # residual
        assert float(row[11]) > 0  # tflops measured

    @pytest.mark.slow
    def test_effective_tflops_modes(self):
        a = generate_input("urand01", (64, 64), seed=0)
        b = generate_input("urand01", (64, 64), seed=1)
        assert effective_tflops(a, b, "fp64_int8_9", 2) > 0
        assert effective_tflops(a, b, "dgemm", 2) > 0
        az = generate_input("urand01", (64, 64), seed=2, complex_=True)
        bz = generate_input("urand01", (64, 64), seed=3, complex_=True)
        assert effective_tflops(az, bz, "fp64_int8_8", 2) > 0

    @pytest.mark.slow
    def test_effective_tflops_rectangular(self):
        # round-1 ADVICE (medium): rectangular shapes crashed the timing
        # chain whenever k > n or k > m (and m != k on the native branch)
        a = generate_input("urand01", (32, 96), seed=4)
        b = generate_input("urand01", (96, 16), seed=5)
        assert effective_tflops(a, b, "fp64_int8_9", 2) > 0
        assert effective_tflops(a, b, "dgemm", 2) > 0
        az = generate_input("urand01", (32, 96), seed=6, complex_=True)
        bz = generate_input("urand01", (96, 16), seed=7, complex_=True)
        assert effective_tflops(az, bz, "fp64_int8_8", 2) > 0

    def test_power_mode_measured_fields(self):
        # run_power must report only measured values (round-1 VERDICT
        # weak #4: iters/avg_time were fabricated)
        import re

        rc, out = self._capture(
            bench_cli.run_power, "dgemm", "fp64_int8_8", 64, 0.5
        )
        assert rc == 0
        m = re.search(
            r"iters=(\d+),avg_time=([0-9.eE+-]+)s,tflops=([0-9.eE+-]+),watts=", out
        )
        assert m, out
        iters, avg_time, tflops = int(m[1]), float(m[2]), float(m[3])
        assert iters > 0 and avg_time > 0
        # iters calls of avg_time each filled the 0.5 s window (avg_time
        # is printed to 5 significant digits)
        assert iters * avg_time * (1 + 1e-4) >= 0.5
        # consistency: tflops == flops / avg_time (both measured; printed
        # fields are rounded to 4 decimals / 4 significant digits)
        flops = 2 * 64**3
        np.testing.assert_allclose(tflops, flops / avg_time / 1e12, rtol=2e-3)

    def test_matfile_raw_roundtrip(self, tmp_path):
        # reference raw-matfile replay parity (main_test.cu:273-302):
        # fp32 and fp64 column-major dumps load exactly and pass the gate
        rng = np.random.default_rng(11)
        a = rng.uniform(size=(24, 40))
        b = rng.uniform(size=(40, 16))
        for dtype, cast in (("fp64", np.float64), ("fp32", np.float32)):
            pa, pb = tmp_path / f"a.{dtype}", tmp_path / f"b.{dtype}"
            np.asarray(a, cast, order="F").T.ravel().tofile(pa)  # col-major
            np.asarray(b, cast, order="F").T.ravel().tofile(pb)
            got = bench_cli.load_raw_matrix(str(pa), 24, 40, dtype)
            np.testing.assert_array_equal(got, np.asarray(a, cast, order="F"))
            rc, out = self._capture(
                bench_cli.main,
                ["matfile_raw", str(pa), str(pb), "24", "40", "16",
                 "--dtype", dtype, "fp64_int8_9"],
            )
            assert rc == 0
            row = out.strip().splitlines()[1].split(",")
            assert row[2] == f"matfile-{dtype}"
            assert float(row[9]) < 1e-15

    def test_matfile_raw_size_mismatch(self, tmp_path):
        import pytest

        p = tmp_path / "x.bin"
        np.zeros(7, np.float64).tofile(p)
        with pytest.raises(ValueError, match="expected"):
            bench_cli.load_raw_matrix(str(p), 2, 4, "fp64")
        with pytest.raises(ValueError, match="dtype"):
            bench_cli.load_raw_matrix(str(p), 7, 1, "int8")

    @pytest.mark.slow
    def test_zhpl_device_gen(self, monkeypatch):
        # complex LU benchmark, device-resident with ON-DEVICE operand
        # generation (the production accelerator configuration; OZ_HPL_DEVICE_GEN
        # forces the path on the CPU backend)
        monkeypatch.setenv("OZ_HPL_DEVICE_GEN", "1")
        rc, out = self._capture(
            bench_cli.main,
            ["hpl", "fp64_int8_9", "96", "--block", "48",
             "--device", "on", "--dtype", "z"],
        )
        assert rc == 0
        row = out.strip().splitlines()[-1]
        assert row.startswith("zhpl,")
        fields = dict(f.split("=") for f in row.split(",") if "=" in f)
        assert float(fields["gflops_x4"]) > 0
        assert float(fields["residual"]) < 1e-14

    def test_hpl_mode(self):
        # HPL-class solver benchmark: schema + gate (factor via main() to
        # cover the CLI wiring)
        rc, out = self._capture(
            bench_cli.main, ["hpl", "fp64_int8_9", "96", "--block", "48"]
        )
        assert rc == 0
        row = out.strip().splitlines()[-1]
        assert row.startswith("hpl,")
        fields = dict(
            f.split("=") for f in row.split(",") if "=" in f
        )
        assert float(fields["factor_time"].rstrip("s")) > 0
        assert float(fields["gflops"]) > 0
        assert float(fields["residual"]) < 1e-14
