"""HPL-class solver tests (ozimmu_tpu/linalg.py): blocked LU with the
engine doing the trailing-matrix GEMMs, triangular solves, and HPL-AI
style iterative refinement."""

import numpy as np
import pytest

from ozimmu_tpu.linalg import cho_solve, cholesky, lu_factor, lu_solve, solve


def _pa_lu_residual(a, lu, piv):
    """||P A - L U||_F / ||A||_F with P reconstructed from getrf pivots."""
    n = a.shape[0]
    pa = a.copy()
    for i in range(n):
        p = piv[i]
        if p != i:
            pa[[i, p], :] = pa[[p, i], :]
    l = np.tril(lu, -1) + np.eye(n, dtype=lu.dtype)
    u = np.triu(lu)
    return np.linalg.norm(pa - l @ u) / np.linalg.norm(a)


def _solve_residual(a, x, b):
    return np.linalg.norm(a @ x - b) / (
        np.linalg.norm(a) * np.linalg.norm(x) + np.linalg.norm(b)
    )


class TestLuFactor:
    def test_factorization_residual_int8_9(self):
        rng = np.random.default_rng(0)
        a = rng.uniform(-1, 1, size=(384, 384))
        lu, piv = lu_factor(a, mode="fp64_int8_9", block=96)
        assert _pa_lu_residual(a, lu, piv) < 1e-14

    def test_matches_native_mode_quality(self):
        # the engine-updated factorization is as good as one whose GEMM
        # updates run in native f64 (same algorithm, mode="dgemm")
        rng = np.random.default_rng(1)
        a = rng.normal(size=(256, 256))
        lu9, piv9 = lu_factor(a, mode="fp64_int8_9", block=64)
        lud, pivd = lu_factor(a, mode="dgemm", block=64)
        r9 = _pa_lu_residual(a, lu9, piv9)
        rd = _pa_lu_residual(a, lud, pivd)
        assert r9 < 2 * rd + 1e-15

    @pytest.mark.slow
    def test_block_edge_cases(self):
        rng = np.random.default_rng(2)
        a = rng.uniform(-1, 1, size=(130, 130))  # n not a block multiple
        for block in (130, 200, 37):
            lu, piv = lu_factor(a, mode="fp64_int8_9", block=block)
            assert _pa_lu_residual(a, lu, piv) < 1e-14, block
        # block=1 (fully unblocked) on a SMALL matrix: every panel step is
        # a distinct trailing shape = a distinct XLA compile, so a large n
        # here costs minutes for no extra coverage
        a = rng.uniform(-1, 1, size=(13, 13))
        lu, piv = lu_factor(a, mode="fp64_int8_9", block=1)
        assert _pa_lu_residual(a, lu, piv) < 1e-14

    def test_pivoting_permutation_matrix(self):
        # a matrix that is mostly a permutation forces pivot swaps at
        # every step; exactness check (no rounding possible)
        n = 64
        perm = np.random.default_rng(3).permutation(n)
        a = np.zeros((n, n))
        a[np.arange(n), perm] = np.arange(1, n + 1, dtype=float)
        lu, piv = lu_factor(a, mode="fp64_int8_9", block=16)
        assert _pa_lu_residual(a, lu, piv) == 0.0

    def test_singular_raises(self):
        a = np.ones((32, 32))
        with pytest.raises(np.linalg.LinAlgError):
            lu_factor(a, mode="fp64_int8_9", block=8)

    @pytest.mark.slow
    def test_complex(self):
        rng = np.random.default_rng(4)
        a = rng.normal(size=(160, 160)) + 1j * rng.normal(size=(160, 160))
        lu, piv = lu_factor(a, mode="fp64_int8_9", block=48)
        assert _pa_lu_residual(a, lu, piv) < 1e-14

    def test_rejects_non_square(self):
        with pytest.raises(ValueError):
            lu_factor(np.ones((4, 5)), mode="fp64_int8_9")

    def test_scipy_path_active_when_scipy_installed(self):
        # guards against CI silently exercising only the numpy fallbacks
        # (ADVICE r3): if scipy is importable, the LAPACK panel/TRSM
        # bindings must have been picked up at module import
        import importlib.util

        if importlib.util.find_spec("scipy") is None:
            pytest.skip("scipy not installed")
        from ozimmu_tpu import linalg as L

        assert L._sp_lu_factor is not None
        assert L._sp_solve_triangular is not None
        assert L._sp_lu_solve is not None

    def test_old_scipy_rectangular_fallback(self, monkeypatch):
        # scipy < 1.10 raises ValueError on the rectangular panel call;
        # the numpy loop must take over and produce the same factorization
        from ozimmu_tpu import linalg as L

        if L._sp_lu_factor is None:
            pytest.skip("scipy not installed")

        def _old_scipy(x, **kw):
            raise ValueError("expected square matrix")

        monkeypatch.setattr(L, "_sp_lu_factor", _old_scipy)
        rng = np.random.default_rng(40)
        a = rng.uniform(-1, 1, size=(96, 96))
        lu, piv = lu_factor(a, mode="fp64_int8_9", block=32)
        assert _pa_lu_residual(a, lu, piv) < 1e-14


class TestSolve:
    def test_solve_vector_and_matrix_rhs(self):
        rng = np.random.default_rng(5)
        a = rng.uniform(-1, 1, size=(300, 300))
        x_true = rng.normal(size=300)
        b = a @ x_true
        x = solve(a, b, mode="fp64_int8_9", block=100)
        assert _solve_residual(a, x, b) < 1e-15
        bm = rng.normal(size=(300, 3))
        xm = solve(a, bm, mode="fp64_int8_9", block=100)
        assert _solve_residual(a, xm, bm) < 1e-15

    def test_hpl_ai_refinement_recovers_f64(self):
        # factor in a CHEAP mode (int8_5: ~4e-10 GEMM residual), then
        # f64-residual refinement converges to working precision — the
        # HPL-AI recipe on the mode Pareto curve
        rng = np.random.default_rng(6)
        a = rng.uniform(-1, 1, size=(256, 256)) + 4 * np.eye(256)
        x_true = rng.normal(size=256)
        b = a @ x_true
        x0 = solve(a, b, mode="fp64_int8_5", block=64)
        r0 = _solve_residual(a, x0, b)
        x = solve(a, b, mode="fp64_int8_5", block=64, refine=3)
        r = _solve_residual(a, x, b)
        assert r0 > 1e-12  # cheap factorization alone is NOT f64-grade
        assert r < 1e-15  # refinement restores it

    def test_sgemm_demotion_refinement(self):
        rng = np.random.default_rng(7)
        a = rng.uniform(-1, 1, size=(192, 192)) + 4 * np.eye(192)
        b = a @ rng.normal(size=192)
        x = solve(a, b, mode="sgemm", block=64, refine=4)
        assert _solve_residual(a, x, b) < 1e-15

    @pytest.mark.slow
    def test_complex_solve(self):
        rng = np.random.default_rng(8)
        a = rng.normal(size=(128, 128)) + 1j * rng.normal(size=(128, 128))
        x_true = rng.normal(size=128) + 1j * rng.normal(size=128)
        b = a @ x_true
        x = solve(a, b, mode="fp64_int8_9", block=48)
        assert _solve_residual(a, x, b) < 1e-15

    def test_lu_solve_rhs_shape_guard(self):
        rng = np.random.default_rng(9)
        a = rng.uniform(-1, 1, size=(32, 32))
        fac = lu_factor(a, mode="fp64_int8_9", block=16)
        with pytest.raises(ValueError):
            lu_solve(fac, np.ones(33))


def _spd(rng, n, complex_=False):
    g = rng.normal(size=(n, n))
    if complex_:
        g = g + 1j * rng.normal(size=(n, n))
    return g @ np.conj(g.T) + n * np.eye(n)


class TestCholesky:
    def test_factorization_residual_int8_9(self):
        rng = np.random.default_rng(10)
        a = _spd(rng, 384)
        l = cholesky(a, mode="fp64_int8_9", block=96)
        assert np.allclose(np.triu(l, 1), 0)  # strict upper zeroed
        assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-14

    def test_block_edge_cases(self):
        rng = np.random.default_rng(11)
        a = _spd(rng, 130)  # n not a block multiple
        for block in (130, 200, 37):
            l = cholesky(a, mode="fp64_int8_9", block=block)
            assert (
                np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-14
            ), block
        a = _spd(rng, 13)  # block=1: one compile per step — keep n tiny
        l = cholesky(a, mode="fp64_int8_9", block=1)
        assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-14

    @pytest.mark.slow
    def test_hermitian_complex(self):
        rng = np.random.default_rng(12)
        a = _spd(rng, 160, complex_=True)
        l = cholesky(a, mode="fp64_int8_9", block=48)
        assert np.linalg.norm(a - l @ np.conj(l.T)) / np.linalg.norm(a) < 1e-14

    def test_reads_lower_triangle_only(self):
        rng = np.random.default_rng(13)
        a = _spd(rng, 96)
        junk = a.copy()
        junk[np.triu_indices(96, 1)] = 1e300  # garbage above the diagonal
        l = cholesky(junk, mode="fp64_int8_9", block=32)
        l_ref = cholesky(a, mode="fp64_int8_9", block=32)
        assert np.array_equal(l, l_ref)

    def test_cho_solve(self):
        rng = np.random.default_rng(14)
        a = _spd(rng, 256)
        x_true = rng.normal(size=256)
        b = a @ x_true
        l = cholesky(a, mode="fp64_int8_9", block=64)
        x = cho_solve(l, b)
        assert _solve_residual(a, x, b) < 1e-15
        bm = rng.normal(size=(256, 3))
        xm = cho_solve(l, bm)
        assert _solve_residual(a, xm, bm) < 1e-15

    def test_cho_solve_complex(self):
        rng = np.random.default_rng(15)
        a = _spd(rng, 128, complex_=True)
        b = a @ (rng.normal(size=128) + 1j * rng.normal(size=128))
        l = cholesky(a, mode="fp64_int8_9", block=48)
        x = cho_solve(l, b)
        assert _solve_residual(a, x, b) < 1e-15

    def test_not_positive_definite_raises(self):
        a = np.eye(64)
        a[40, 40] = -1.0
        with pytest.raises(np.linalg.LinAlgError):
            cholesky(a, mode="fp64_int8_9", block=16)

    def test_rejects_non_square(self):
        with pytest.raises(ValueError):
            cholesky(np.ones((4, 5)), mode="fp64_int8_9")


class TestDeviceResident:
    """Device-resident factorizations (VERDICT r3 item 2): the trailing
    matrix stays on device as F64X bit planes; only the pivot panel (LU)
    or diagonal block (Cholesky) crosses the host boundary."""

    def test_lu_device_residual_and_pivots(self):
        rng = np.random.default_rng(30)
        a = rng.uniform(-1, 1, size=(384, 384))
        lu, piv = lu_factor(a, mode="fp64_int8_9", block=96, device=True)
        assert _pa_lu_residual(a, lu, piv) < 1e-14
        # pivots are genuine partial pivots: each at or below the diagonal
        assert all(piv[i] >= i for i in range(384))

    @pytest.mark.slow
    def test_lu_f64x_in_f64x_out(self):
        from ozimmu_tpu.core.f64x import F64X

        rng = np.random.default_rng(31)
        a = rng.uniform(-1, 1, size=(130, 130))  # n not a block multiple
        aX = F64X.from_numpy(a)
        luX, piv = lu_factor(aX, mode="fp64_int8_9", block=48)
        assert isinstance(luX, F64X)
        lu = luX.to_numpy().reshape(130, 130)
        assert _pa_lu_residual(a, lu, piv) < 1e-14
        # the input planes are not destroyed by the donated step programs
        np.testing.assert_array_equal(aX.to_numpy().reshape(130, 130), a)

    def test_solve_f64x_with_refinement(self):
        from ozimmu_tpu.core.f64x import F64X

        rng = np.random.default_rng(32)
        n = 192
        a = rng.uniform(-1, 1, size=(n, n)) + n * np.eye(n)
        x_true = rng.standard_normal(n)
        b = a @ x_true
        aX = F64X.from_numpy(a)
        x = solve(aX, b, mode="fp64_int8_6", block=64, refine=2)
        assert _solve_residual(a, x, b) < 1e-15

    @pytest.mark.slow
    def test_cholesky_device_residual(self):
        rng = np.random.default_rng(33)
        a = _spd(rng, 200)
        l = cholesky(a, mode="fp64_int8_9", block=64, device=True)
        assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-14
        assert np.allclose(np.triu(l, 1), 0.0)

    def test_cholesky_f64x_in_f64x_out(self):
        from ozimmu_tpu.core.f64x import F64X

        rng = np.random.default_rng(34)
        a = _spd(rng, 130)
        lX = cholesky(F64X.from_numpy(a), mode="fp64_int8_9", block=48)
        assert isinstance(lX, F64X)
        l = lX.to_numpy().reshape(130, 130)
        assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-14

    def test_device_needs_fixed_int8_mode(self):
        a = np.eye(16)
        with pytest.raises(ValueError, match="fixed fp64_int8"):
            lu_factor(a, mode="dgemm", device=True)
        with pytest.raises(ValueError, match="fixed fp64_int8"):
            cholesky(a, mode="fp64_int8_auto", device=True)

    @pytest.mark.slow
    def test_device_complex_host_panels_matches_host_path(self):
        # complex device-resident LU (VERDICT r4 item 6): host panels are
        # exact complex getrf bits, trailing updates exact engine ZGEMMs
        # -> pivots identical to the all-host path, residual at the gate
        rng = np.random.default_rng(41)
        n = 96
        a = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
        lu_d, piv_d = lu_factor(a, mode="fp64_int8_9", block=32, device=True)
        lu_h, piv_h = lu_factor(a, mode="fp64_int8_9", block=32, device=False)
        assert lu_d.dtype == np.complex128
        np.testing.assert_array_equal(piv_d, piv_h)
        l = np.tril(lu_d, -1) + np.eye(n)
        u = np.triu(lu_d)
        pa = a.copy()
        for i in range(n):
            p = piv_d[i]
            if p != i:
                pa[[i, p], :] = pa[[p, i], :]
        r = np.linalg.norm(l @ u - pa) / np.linalg.norm(a)
        assert r < 1e-14

    def test_device_complex_device_panels(self):
        # fully resident complex variant: platform-f64 panels on device,
        # |re|+|im| pivoting (LAPACK dcabs1) -> same pivot sequence as
        # host getrf on ties-free random data
        rng = np.random.default_rng(42)
        n = 64
        a = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
        lu_d, piv_d = lu_factor(
            a, mode="fp64_int8_9", block=32, device=True, panel="device"
        )
        lu_h, piv_h = lu_factor(a, mode="fp64_int8_9", block=32, device=False)
        np.testing.assert_array_equal(piv_d, piv_h)
        l = np.tril(lu_d, -1) + np.eye(n)
        u = np.triu(lu_d)
        pa = a.copy()
        for i in range(n):
            p = piv_d[i]
            if p != i:
                pa[[i, p], :] = pa[[p, i], :]
        r = np.linalg.norm(l @ u - pa) / np.linalg.norm(a)
        assert r < 1e-14

    @pytest.mark.slow
    def test_device_complex_solve_end_to_end(self):
        rng = np.random.default_rng(43)
        n = 48
        a = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
        a += n * np.eye(n)
        x_true = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        b = a @ x_true
        fac = lu_factor(a, mode="fp64_int8_9", block=16, device=True)
        x = lu_solve(fac, b)
        assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-13

    def test_profile_dict_populated(self):
        rng = np.random.default_rng(35)
        a = rng.uniform(-1, 1, size=(96, 96))
        prof = {}
        lu_factor(a, mode="fp64_int8_9", block=32, device=True, profile=prof)
        assert {"panel_pull_s", "panel_host_s", "device_update_s"} <= set(prof)
        assert all(v >= 0 for v in prof.values())


class TestDevicePanels:
    """panel="device": the pivot panel is factored ON DEVICE in the
    platform's f64 (true IEEE on CPU — bit-comparable to the host panel
    path there), making the factorization a chain of async device steps
    with no per-step host traffic."""

    @pytest.mark.slow
    def test_residual_and_pivots_match_host_panel(self):
        rng = np.random.default_rng(50)
        a = rng.uniform(-1, 1, size=(384, 384))
        lu_d, piv_d = lu_factor(
            a, mode="fp64_int8_9", block=96, device=True, panel="device"
        )
        lu_h, piv_h = lu_factor(
            a, mode="fp64_int8_9", block=96, device=True, panel="host"
        )
        assert _pa_lu_residual(a, lu_d, piv_d) < 1e-14
        # on CPU both panels compute in the same true f64 -> same pivots
        np.testing.assert_array_equal(piv_d, piv_h)

    def test_block_not_dividing_n(self):
        rng = np.random.default_rng(51)
        a = rng.uniform(-1, 1, size=(130, 130))
        lu, piv = lu_factor(
            a, mode="fp64_int8_9", block=48, device=True, panel="device"
        )
        assert _pa_lu_residual(a, lu, piv) < 1e-14

    def test_singular_raises(self):
        a = np.zeros((16, 16))
        with pytest.raises(np.linalg.LinAlgError, match="zero pivot"):
            lu_factor(a, mode="fp64_int8_9", block=8, device=True,
                      panel="device")

    @pytest.mark.slow
    def test_pivoting_actually_pivots(self):
        # anti-diagonal-ish matrix: every step must swap
        n = 64
        a = np.eye(n)[::-1] + 1e-3 * np.eye(n)
        lu, piv = lu_factor(
            a, mode="fp64_int8_9", block=16, device=True, panel="device"
        )
        assert _pa_lu_residual(a, lu, piv) < 1e-14
        assert any(piv[i] != i for i in range(n))

    @pytest.mark.slow
    def test_solve_with_device_panels_and_refinement(self):
        from ozimmu_tpu.core.f64x import F64X

        rng = np.random.default_rng(52)
        n = 192
        a = rng.uniform(-1, 1, size=(n, n)) + n * np.eye(n)
        x_true = rng.standard_normal(n)
        b = a @ x_true
        aX = F64X.from_numpy(a)
        fac = lu_factor(aX, mode="fp64_int8_6", block=64, panel="device")
        x = solve(aX, b, refine=2, factor=fac)
        assert _solve_residual(a, x, b) < 1e-15

    def test_invalid_panel_value(self):
        with pytest.raises(ValueError, match="panel"):
            lu_factor(np.eye(8), mode="fp64_int8_9", device=True,
                      panel="bogus")


class TestShardedLU:
    """lu_factor(mesh=...): the device-resident factorization row-sharded
    over a mesh, GSPMD-partitioned.  The engine's cross-device arithmetic
    is exact, so the sharded run must be BITWISE-identical to the
    single-device one."""

    def _mesh(self):
        import jax
        from jax.sharding import Mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        return Mesh(np.array(jax.devices()[:8]), ("x",))

    @pytest.mark.slow
    def test_bitwise_same_as_single_device_host_panel(self):
        # host panels: every on-device op is exact (int32 dots, fixed
        # fold tree, elementwise epilogue) -> sharding cannot change bits
        mesh = self._mesh()
        rng = np.random.default_rng(60)
        a = rng.uniform(-1, 1, size=(128, 128))
        lu_s, piv_s = lu_factor(
            a, mode="fp64_int8_9", block=32, mesh=mesh, panel="host"
        )
        lu_1, piv_1 = lu_factor(
            a, mode="fp64_int8_9", block=32, device=True, panel="host"
        )
        np.testing.assert_array_equal(piv_s, piv_1)
        np.testing.assert_array_equal(
            lu_s.view(np.uint64), lu_1.view(np.uint64)
        )
        assert _pa_lu_residual(a, lu_s, piv_s) < 1e-14

    @pytest.mark.slow
    def test_device_panel_matches_single_device(self):
        # device panels run platform-f64 matmuls (TRSM/inverse blocks)
        # whose reduction blocking is shape-dependent in XLA, so sharding
        # is NOT bitwise-reproducible there — the guarantee is the same
        # pivot sequence (no near-ties at these magnitudes) and platform-
        # f64-roundoff agreement, with the factorization residual intact
        mesh = self._mesh()
        rng = np.random.default_rng(60)
        a = rng.uniform(-1, 1, size=(128, 128))
        lu_s, piv_s = lu_factor(
            a, mode="fp64_int8_9", block=32, mesh=mesh, panel="device"
        )
        lu_1, piv_1 = lu_factor(
            a, mode="fp64_int8_9", block=32, device=True, panel="device"
        )
        np.testing.assert_array_equal(piv_s, piv_1)
        rel = np.abs(lu_s - lu_1).max() / np.abs(lu_1).max()
        assert rel < 1e-13, rel
        assert _pa_lu_residual(a, lu_s, piv_s) < 1e-14

    @pytest.mark.slow
    def test_sharded_cholesky_bitwise(self):
        from ozimmu_tpu.linalg import cholesky

        mesh = self._mesh()
        rng = np.random.default_rng(62)
        g = rng.uniform(-1, 1, size=(96, 96))
        a = g @ g.T + 96 * np.eye(96)
        l_s = cholesky(a, mode="fp64_int8_9", block=24, mesh=mesh)
        l_1 = cholesky(a, mode="fp64_int8_9", block=24, device=True)
        np.testing.assert_array_equal(
            l_s.view(np.uint64), l_1.view(np.uint64)
        )
        rel = np.linalg.norm(a - l_s @ l_s.T) / np.linalg.norm(a)
        assert rel < 1e-14, rel

    def test_solve_through_sharded_factor(self):
        mesh = self._mesh()
        rng = np.random.default_rng(61)
        a = rng.uniform(-1, 1, size=(96, 96)) + 96 * np.eye(96)
        x_true = rng.standard_normal(96)
        b = a @ x_true
        fac = lu_factor(a, mode="fp64_int8_9", block=24, mesh=mesh)
        x = lu_solve(fac, b)
        assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-12


class TestTracedPanelHelpers:
    """Direct parity of the recursive traced panel kernels against the
    unblocked numpy factorization (the device-panel LU path is built on
    these; recursion changes the rounding order but must preserve the
    pivot SEQUENCE and the factorization up to platform-f64 roundoff)."""

    @pytest.mark.parametrize(
        "rows,jb",
        [
            (7, 3),
            (33, 17),
            pytest.param(128, 96, marks=pytest.mark.slow),
            pytest.param(200, 64, marks=pytest.mark.slow),
            (100, 1),
        ],
    )
    def test_panel_matches_numpy(self, rows, jb):
        import jax
        import jax.numpy as jnp

        from ozimmu_tpu.linalg import (
            _numpy_panel_factor_local,
            _panel_factor_traced,
        )

        rng = np.random.default_rng(rows * 1000 + jb)
        p = rng.standard_normal((rows, jb))
        lu_ref, ploc_ref = _numpy_panel_factor_local(p.copy())
        lu, ploc, ok = jax.jit(
            lambda x: _panel_factor_traced(x, jb)
        )(jnp.asarray(p))
        assert bool(ok)
        np.testing.assert_array_equal(np.asarray(ploc), ploc_ref)
        rel = np.abs(np.asarray(lu) - lu_ref).max() / np.abs(lu_ref).max()
        assert rel < 1e-13, rel

    @pytest.mark.parametrize("w", [1, 5, 17, 129, 256])
    def test_unit_lower_inverse(self, w):
        import jax
        import jax.numpy as jnp

        from ozimmu_tpu.linalg import _unit_lower_inverse_traced

        rng = np.random.default_rng(w)
        # partial-pivoted L has |strict lower| <= 1 (realistic conditioning)
        l = np.tril(rng.uniform(-1, 1, (w, w)), -1) + np.eye(w)
        inv = np.asarray(jax.jit(_unit_lower_inverse_traced)(jnp.asarray(l)))
        ref = np.linalg.inv(l)
        rel = np.abs(inv - ref).max() / max(1.0, np.abs(ref).max())
        assert rel < 1e-12, rel

    def test_singular_panel_flagged(self):
        import jax
        import jax.numpy as jnp

        from ozimmu_tpu.linalg import _panel_factor_traced

        p = np.zeros((8, 4))
        p[:, 1:] = np.random.default_rng(3).standard_normal((8, 3))
        _, _, ok = jax.jit(lambda x: _panel_factor_traced(x, 4))(
            jnp.asarray(p)
        )
        assert not bool(ok)


class TestFromF64DD:
    def test_exact_on_cpu_normal_range(self):
        import jax.numpy as jnp

        from ozimmu_tpu.core.f64x import from_f64

        rng = np.random.default_rng(53)
        v = rng.standard_normal(8192) * np.exp(80 * rng.standard_normal(8192))
        v[:6] = [0.0, -0.0, 2.0**1023, np.finfo(np.float64).max,
                 np.finfo(np.float64).tiny, 1.0]
        out = from_f64(jnp.asarray(v, dtype=jnp.float64)).to_numpy()
        np.testing.assert_array_equal(out.view(np.uint64), v.view(np.uint64))

    @pytest.mark.slow
    def test_subnormals_exact(self):
        # the bitcast carries subnormals unchanged (no arithmetic touches
        # them, so no backend's denormal flushing applies)
        import jax.numpy as jnp

        from ozimmu_tpu.core.f64x import from_f64

        v = np.array([2.0**-1040, -5e-324])
        out = from_f64(jnp.asarray(v, dtype=jnp.float64)).to_numpy()
        np.testing.assert_array_equal(out.view(np.uint64), v.view(np.uint64))
