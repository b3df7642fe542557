"""Test/benchmark input generators and error metrics.

Reproduces the reference harness surface:
  - input distributions ``urand01`` / ``normal01`` / ``exp_rand-<phi>``
    (reference test/main_test.cu:56-80, 195-232).  ``exp_rand`` draws
    ``(u - 0.5) * exp(phi * randn)`` to generate wide exponent spread.
  - error metrics ``relative_residual`` and ``max_relative_error`` against
    a higher-precision reference GEMM (reference test/mateval usage at
    test/main_test.cu:101-117).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate_input(
    name: str, shape, seed: int = 0, complex_: bool = False
) -> np.ndarray:
    """Generate a test matrix per the named distribution."""
    rng = np.random.default_rng(seed)

    def gen(sd):
        r = np.random.default_rng(sd)
        if name == "urand01":
            return r.uniform(0.0, 1.0, size=shape)
        if name == "normal01":
            return r.normal(0.0, 1.0, size=shape)
        if name.startswith("exp_rand"):
            phi = float(name.split("-", 1)[1]) if "-" in name else 1.0
            u = r.uniform(0.0, 1.0, size=shape)
            g = r.normal(0.0, 1.0, size=shape)
            return (u - 0.5) * np.exp(phi * g)
        raise ValueError(f"unknown input distribution: {name!r}")

    if complex_:
        return gen(seed) + 1j * gen(seed + 10**6)
    return gen(seed)


def reference_gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Higher-precision reference product (mateval equivalent).

    Uses longdouble (80-bit extended on x86) accumulation.
    """
    return (a.astype(np.clongdouble) if np.iscomplexobj(a) else a.astype(np.longdouble)) @ (
        b.astype(np.clongdouble) if np.iscomplexobj(b) else b.astype(np.longdouble)
    )


def error_metrics(
    c: np.ndarray, a: np.ndarray, b: np.ndarray, c_ref=None
) -> Dict[str, float]:
    """relative_residual and max_relative_error vs a higher-precision ref
    (reference test/main_test.cu:101-117).

    Uses the native OpenMP long-double oracle when available (streamed —
    no reference buffer), falling back to numpy longdouble."""
    if c_ref is None:
        from . import native

        res = native.error_metrics_native(np.asarray(c), np.asarray(a), np.asarray(b))
        if res is not None:
            return res
        c_ref = reference_gemm(a, b)
    diff = c.astype(c_ref.dtype) - c_ref
    denom = np.linalg.norm(c_ref.astype(np.complex128 if np.iscomplexobj(c_ref) else np.float64))
    residual = float(
        np.linalg.norm(diff.astype(np.complex128 if np.iscomplexobj(diff) else np.float64)) / denom
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(diff) / np.abs(c_ref)
        rel = np.where(np.abs(c_ref) == 0, 0.0, rel)
    return {
        "relative_residual": residual,
        "max_relative_error": float(np.max(rel)),
    }


def _make_call(a: np.ndarray, b: np.ndarray, mode):
    """One GEMM through the mode's device path, operands already on device.

    Returns ``(call, flops)``: ``call()`` dispatches ``op(a) @ op(b)``
    once and returns its device outputs.  Int8 modes run the engine
    (auto column-panel chunking included); ``dgemm`` the native f64 /
    complex128 product; ``sgemm`` the f32 / complex64 product at HIGHEST
    precision (what the API's demotion mode computes — the GPU's default
    f32 matmul may run in TF32).
    """
    import jax
    import jax.numpy as jnp

    from .core.api import _native_gemm
    from .core.f64x import F64X
    from .core.gemm import gemm_f64x, zgemm_f64x
    from .types import ComputeMode

    mode = ComputeMode.parse(mode)
    complex_ = np.iscomplexobj(a) or np.iscomplexobj(b)
    m, k = a.shape
    n = b.shape[1]
    flops = 2 * m * n * k * (4 if complex_ else 1)

    if mode.is_int8 and complex_:
        ns = mode.num_split
        planes = [
            F64X.from_numpy(np.ascontiguousarray(p))
            for p in (a.real, a.imag, b.real, b.imag)
        ]
        return (lambda: zgemm_f64x(*planes, ns)), flops
    if mode.is_int8:
        ns = mode.num_split
        ax = F64X.from_numpy(np.ascontiguousarray(a, np.float64))
        bx = F64X.from_numpy(np.ascontiguousarray(b, np.float64))
        return (lambda: gemm_f64x(ax, bx, ns)), flops
    if mode is ComputeMode.SGEMM:
        dt = jnp.complex64 if complex_ else jnp.float32
        aj, bj = jnp.asarray(a, dt), jnp.asarray(b, dt)
        f32_dot = jax.jit(
            lambda x, y: jnp.matmul(
                x, y, preferred_element_type=dt,
                precision=jax.lax.Precision.HIGHEST,
            )
        )
        return (lambda: f32_dot(aj, bj)), flops
    dt = jnp.complex128 if complex_ else jnp.float64
    aj, bj = jnp.asarray(a, dt), jnp.asarray(b, dt)
    one = 1.0 + 0j if complex_ else 1.0
    zero = 0j if complex_ else 0.0
    return (lambda: _native_gemm(aj, bj, one, zero)), flops


def effective_tflops(
    a: np.ndarray,
    b: np.ndarray,
    mode,
    test_count: int = 8,
) -> float:
    """Effective FP64 TFLOPS (2mnk / t, x4 complex) of one GEMM.

    One untimed warm-up call (compiles), then ``test_count`` calls, each
    timed on the host clock up to ``block_until_ready``; the median call
    time is reported.  Operands must already have transposes applied.
    """
    import time

    import jax

    call, flops = _make_call(a, b, mode)
    jax.block_until_ready(call())
    times = []
    for _ in range(max(1, test_count)):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        times.append(time.perf_counter() - t0)
    return flops / float(np.median(times)) / 1e12


def sustained_run(
    a: np.ndarray,
    b: np.ndarray,
    mode,
    min_seconds: float = 10.0,
    on_measure_start=None,
):
    """Sustained-load measurement (reference power mode, main_test.cu:408-512).

    After one untimed warm-up call, back-to-back calls (each ending in
    ``block_until_ready``) run until ``min_seconds`` of wall clock are
    spent.  Returns ``(tflops, iters, avg_time_s)`` with ``avg_time_s =
    elapsed / iters``.  ``on_measure_start`` (if given) is called when the
    measured window opens, after the compile — power samplers hook here
    so the sampling window covers only load (reference
    main_test.cu:473-498 samples only during its run loops).
    """
    import time

    import jax

    call, flops = _make_call(a, b, mode)
    jax.block_until_ready(call())
    if on_measure_start is not None:
        on_measure_start()
    t0 = time.perf_counter()
    iters = 0
    while True:
        jax.block_until_ready(call())
        iters += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= min_seconds:
            break
    avg = elapsed / iters
    return flops / avg / 1e12, iters, avg
