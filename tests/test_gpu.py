"""Tests that need an NVIDIA GPU: the engine there is bitwise equal to the
same calls on the CPU device of the same process.

The engine's split, int8 products, integer group totals, f32 triple
arithmetic and f64 bit assembly are exact or correctly rounded, so a GPU
that keeps IEEE f32 semantics gives the CPU's bits.  What could break
that on the GPU — f32 denormals flushed, a multiply and an add contracted
into one FMA, an f32 matmul run in TF32 — is what these tests catch.
They skip without a GPU; ``python chip_smoke.py`` runs them on the card
(``OZ_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu.py`` does
the same by hand).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ozimmu_tpu as oz
import ozimmu_tpu.intercept as ozi
from ozimmu_tpu.core.f64x import from_f64, to_f64
from ozimmu_tpu.ops import tf32x3
from ozimmu_tpu.ops.split import split_f64x
from ozimmu_tpu.testing import error_metrics, generate_input

pytestmark = pytest.mark.gpu


def _on(dev, fn):
    with jax.default_device(dev):
        return fn()


def _cpu():
    return jax.devices("cpu")[0]


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint64)


@pytest.mark.parametrize("mode", ["fp64_int8_9", "fp64_int8_18"])
def test_dgemm_bitwise_vs_cpu(gpu_device, mode):
    a = generate_input("exp_rand-4", (200, 333), seed=1)
    b = generate_input("exp_rand-4", (333, 150), seed=2)
    g = _on(gpu_device, lambda: oz.gemm(a, b, mode=mode))
    c = _on(_cpu(), lambda: oz.gemm(a, b, mode=mode))
    np.testing.assert_array_equal(_bits(g), _bits(c))


@pytest.mark.parametrize("alpha,beta", [(0.3, -1.7), (-1.0, 1.0)])
def test_epilogue_alpha_beta_bitwise_vs_cpu(gpu_device, alpha, beta):
    a = generate_input("normal01", (96, 160), seed=3)
    b = generate_input("normal01", (160, 80), seed=4)
    c0 = generate_input("normal01", (96, 80), seed=5)

    def run():
        return oz.gemm(a, b, mode="fp64_int8_9", alpha=alpha, beta=beta, c=c0)

    np.testing.assert_array_equal(_bits(_on(gpu_device, run)), _bits(_on(_cpu(), run)))


def test_zgemm_bitwise_vs_cpu(gpu_device):
    a = generate_input("urand01", (64, 96), seed=6, complex_=True)
    b = generate_input("urand01", (96, 48), seed=7, complex_=True)

    def run():
        return oz.gemm(a, b, mode="fp64_int8_9", alpha=0.5 - 0.25j)

    np.testing.assert_array_equal(_bits(_on(gpu_device, run)), _bits(_on(_cpu(), run)))


def test_split_bitwise_vs_cpu(gpu_device):
    x = generate_input("exp_rand-8", (128, 256), seed=8)

    def run():
        d, p = split_f64x(oz.F64X.from_numpy(x), 9, 7)
        return np.asarray(d), np.asarray(p)

    (dg, pg), (dc, pc) = _on(gpu_device, run), _on(_cpu(), run)
    np.testing.assert_array_equal(dg, dc)
    np.testing.assert_array_equal(pg, pc)


def test_triple_f32_arithmetic_bitwise_vs_cpu(gpu_device):
    """tf32x3.mul / add on random triples: an FMA-contracted product or a
    flushed denormal on the GPU would change low bits."""
    rng = np.random.default_rng(9)

    def triple(shape):
        h = rng.standard_normal(shape).astype(np.float32)
        m = (h * rng.standard_normal(shape) * 2.0**-25).astype(np.float32)
        t = (m * rng.standard_normal(shape) * 2.0**-25).astype(np.float32)
        return h, m, t

    x, y = triple((4096,)), triple((4096,))

    def run():
        f = jax.jit(lambda x, y: (tf32x3.mul(x, y), tf32x3.add(x, y)))
        return jax.tree_util.tree_map(np.asarray, f(x, y))

    g, c = _on(gpu_device, run), _on(_cpu(), run)
    for u, v in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(c)):
        np.testing.assert_array_equal(u.view(np.uint32), v.view(np.uint32))


def test_bitcast_roundtrip_extremes_on_gpu(gpu_device):
    v = np.array([2.0**200, -(2.0**-1000), 5e-324, -0.0, 0.0, np.inf, -np.inf,
                  np.nan, np.finfo(np.float64).max, 1.0 / 3.0])
    x = jax.device_put(v, gpu_device)
    fx = jax.jit(from_f64)(x)
    np.testing.assert_array_equal(_bits(fx.to_numpy()), _bits(v))
    back = np.asarray(jax.jit(to_f64)(fx))
    np.testing.assert_array_equal(_bits(back), _bits(v))


def test_sgemm_is_true_f32_not_tf32(gpu_device):
    a = generate_input("urand01", (256, 256), seed=10)
    b = generate_input("urand01", (256, 256), seed=11)
    c = _on(gpu_device, lambda: oz.gemm(a, b, mode="sgemm"))
    # f32 accumulation of 256 terms: ~1e-7; TF32 products would give ~1e-4
    assert error_metrics(c, a, b)["relative_residual"] < 1e-6


def test_intercept_routes_on_gpu(gpu_device):
    a = jax.device_put(generate_input("urand01", (1024, 1024), seed=12), gpu_device)
    b = jax.device_put(generate_input("urand01", (1024, 1024), seed=13), gpu_device)
    before = ozi.routed_calls().get("2d", 0)
    with ozi.intercept(mode="fp64_int8_9"):
        c = np.asarray(jax.jit(lambda x, y: x @ y)(a, b))
    assert ozi.routed_calls().get("2d", 0) == before + 1
    want = _on(gpu_device, lambda: oz.gemm(np.asarray(a), np.asarray(b), mode="fp64_int8_9"))
    np.testing.assert_array_equal(_bits(c), _bits(want))


def test_dgemm_mode_runs_on_gpu(gpu_device):
    a = generate_input("normal01", (128, 64), seed=14)
    b = generate_input("normal01", (64, 96), seed=15)
    c = _on(gpu_device, lambda: oz.gemm(a, b, mode="dgemm", alpha=2.0))
    ref = 2.0 * (jnp.asarray(a) @ jnp.asarray(b))
    assert np.max(np.abs(c - np.asarray(ref))) <= 1e-12 * np.max(np.abs(c))
