"""Headline benchmark: effective FP64 TFLOP/s of emulated DGEMM on one GPU.

Prints ONE JSON line on stdout::

  {"metric": ..., "value": N, "unit": "TFLOPS", "vs_baseline": R,
   "native_tflops": N, "residual_vs_native": r, "n_chunks": c,
   "device": {"platform": ..., "kind": ..., "count": ..., "power": ...}}

``value`` — effective FP64 TFLOP/s (2*m*n*k / t) of ``fp64_int8_<ns>``
DGEMM through the engine's public device path (``gemm_f64x``, auto
column-panel chunking included).  ``vs_baseline`` — its ratio to the
native float64 ``jnp.dot`` (cuBLAS DGEMM) timed in the same process.

Timing: one untimed warm-up call per program (compiles), then
``OZ_BENCH_ITERS`` calls, each timed on the host clock up to
``block_until_ready``; the median is reported.  Operands are generated on
the device from a fixed seed.  Diagnostics go to stderr.  Without a GPU
the run exits non-zero and prints no result; any failure exits non-zero.

Env: ``OZ_BENCH_M`` (16384), ``OZ_BENCH_NS`` (9), ``OZ_BENCH_ITERS`` (5).
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ozimmu_tpu.bench_cli import gpu_power_limit  # noqa: E402
from ozimmu_tpu.core.api import _native_gemm  # noqa: E402
from ozimmu_tpu.core.f64x import from_f64, to_f64  # noqa: E402
from ozimmu_tpu.core.gemm import gemm_f64x  # noqa: E402
from ozimmu_tpu.schedule import auto_n_chunks  # noqa: E402
from ozimmu_tpu.utils.cache import enable_compile_cache  # noqa: E402

M = int(os.environ.get("OZ_BENCH_M", 16384))  # north-star size (BASELINE.md)
NS = int(os.environ.get("OZ_BENCH_NS", 9))
ITERS = int(os.environ.get("OZ_BENCH_ITERS", 5))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def median_seconds(call, iters):
    jax.block_until_ready(call())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"bench.py measures a GPU; JAX found {devs[0].platform} only")
        sys.exit(2)
    power = gpu_power_limit()
    log(f"device: {devs[0].device_kind} x{len(devs)}  nvidia-smi: {power}")

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.uniform(k1, (M, M), dtype=jnp.float64)
    b = jax.random.uniform(k2, (M, M), dtype=jnp.float64)
    ax, bx = from_f64(a), from_f64(b)

    nc = auto_n_chunks(M, M, M, NS)
    t_eng = median_seconds(lambda: gemm_f64x(ax, bx, NS), ITERS)
    t_nat = median_seconds(lambda: _native_gemm(a, b, 1.0, 0.0), ITERS)
    flops = 2.0 * M**3
    tflops, native = flops / t_eng / 1e12, flops / t_nat / 1e12
    log(f"engine: {t_eng * 1e3:.3f} ms -> {tflops:.3f} TFLOPS (n_chunks={nc})")
    log(f"native f64: {t_nat * 1e3:.3f} ms -> {native:.3f} TFLOPS")

    c_eng = to_f64(gemm_f64x(ax, bx, NS))
    c_nat = _native_gemm(a, b, 1.0, 0.0)
    resid = float(jnp.linalg.norm(c_eng - c_nat) / jnp.linalg.norm(c_nat))
    if not resid < 1e-14:
        raise SystemExit(f"engine residual vs native {resid:.3e} >= 1e-14")

    print(json.dumps({
        "metric": f"fp64_int8_{NS} effective FP64 TFLOPS (m=n=k={M})",
        "value": tflops,
        "unit": "TFLOPS",
        "vs_baseline": tflops / native,
        "native_tflops": native,
        "residual_vs_native": resid,
        "n_chunks": nc,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
            "power": power,
        },
    }))


if __name__ == "__main__":
    main()
