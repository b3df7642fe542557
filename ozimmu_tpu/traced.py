"""Pure-functional, jittable GEMM entry points for JAX programs.

The public :func:`ozimmu_tpu.gemm` is host-centric (exact numpy bits in
and out) and the interceptor is global state.  This module is the third
surface: call the engine *inside* your own ``jax.jit`` code, no
interception, no host round-trips::

    from ozimmu_tpu import traced

    @jax.jit
    def step(a, b, c):                  # platform f64 arrays
        return traced.gemm(a, b, alpha=2.0, beta=1.0, c=c, num_split=9)

Operands are float64 / complex128 arrays.  Their exact IEEE bits are
taken with one bitcast (intercept.f64_to_f64x_traced), the engine
computes the product of the stored values, and the result is bitcast
back — no host round trip, every value exact (subnormals and values
outside float32's range included).

Semantics match ``mtk::ozimmu::gemm`` (reference src/gemm.cu:524-653):
``alpha * a @ b + beta * c`` at a fixed split count.  For data-driven
split-count selection under jit use the interceptor's AUTO mode
(ozimmu_tpu.intercept) — candidate pruning and the lax.switch live
there.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .core.gemm import gemm_f64x, zgemm_f64x
from .intercept import f64_to_f64x_traced, f64x_to_f64_traced
from .schedule import bits_per_int8


def _check_k(k: int) -> None:
    if bits_per_int8(k) <= 0:
        raise ValueError(f"k={k} exceeds the int8 emulation bound")


def gemm(
    a: jax.Array,
    b: jax.Array,
    *,
    num_split: int = 9,
    alpha=1.0,
    beta=0.0,
    c: Optional[jax.Array] = None,
    n_chunks: Optional[int] = None,
):
    """Jittable ``alpha * a @ b + beta * c`` on [m,k] @ [k,n] arrays.

    float64 inputs run the real engine; complex128 inputs the 4-pass
    complex engine.  ``num_split``/``alpha``/``beta`` must be static
    under jit (they shape the compiled program).

    ``n_chunks=None`` auto-selects column-panel streaming from the
    working-set estimate (schedule.auto_n_chunks) at trace time, so huge
    shapes compile into the memory-bounded chunked engine with no knobs;
    pass 1 to force the single-graph engine.  Chunked results are
    bitwise-identical.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2D operands, got {a.shape} @ {b.shape}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    _check_k(a.shape[1])
    if beta != 0 and c is None:
        raise ValueError("beta != 0 requires c")

    if jnp.iscomplexobj(a) or jnp.iscomplexobj(b):
        a = a.astype(jnp.complex128)
        b = b.astype(jnp.complex128)
        ar = f64_to_f64x_traced(jnp.real(a))
        ai = f64_to_f64x_traced(jnp.imag(a))
        br = f64_to_f64x_traced(jnp.real(b))
        bi = f64_to_f64x_traced(jnp.imag(b))
        cr = ci = None
        if c is not None:
            c = c.astype(jnp.complex128)
            cr = f64_to_f64x_traced(jnp.real(c))
            ci = f64_to_f64x_traced(jnp.imag(c))
        out_re, out_im = zgemm_f64x(
            ar, ai, br, bi, num_split, complex(alpha), complex(beta), cr, ci,
            n_chunks=n_chunks,
        )
        return jax.lax.complex(
            f64x_to_f64_traced(out_re), f64x_to_f64_traced(out_im)
        )

    ax = f64_to_f64x_traced(a.astype(jnp.float64))
    bx = f64_to_f64x_traced(b.astype(jnp.float64))
    cx = f64_to_f64x_traced(c.astype(jnp.float64)) if c is not None else None
    out = gemm_f64x(ax, bx, num_split, float(alpha), float(beta), cx, n_chunks=n_chunks)
    return f64x_to_f64_traced(out)


def matmul(a: jax.Array, b: jax.Array, *, num_split: int = 9):
    """Jittable ``a @ b`` through the engine."""
    return gemm(a, b, num_split=num_split)


def gemm_batched(
    a: jax.Array,
    b: jax.Array,
    *,
    num_split: int = 9,
    alpha=1.0,
    beta=0.0,
    c: Optional[jax.Array] = None,
):
    """Jittable batched GEMM [B,m,k] @ [B,k,n] (vmapped engine)."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"expected 3D operands, got {a.shape} @ {b.shape}")
    _check_k(a.shape[2])
    if beta != 0 and c is None:
        raise ValueError("beta != 0 requires c")
    if c is None:
        return jax.vmap(
            lambda x, y: gemm(x, y, num_split=num_split, alpha=alpha)
        )(a, b)
    return jax.vmap(
        lambda x, y, z: gemm(x, y, num_split=num_split, alpha=alpha, beta=beta, c=z)
    )(a, b, c)
