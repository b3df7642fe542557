"""Recombination: slice-pair int8 matmuls + exact extended accumulation.

Replaces the reference's per-pair loop (src/gemm.cu:385-403: 45 separate
``cublasGemmEx`` int8 GEMMs + 45 f64 accumulate kernels for ns=9) with:

  1. Pairs sharing ``t = i + j`` have the same recombination weight
     ``2^(2 - b t)``, so their int32 partial products are summed exactly
     in int32 before any floating-point work: one int8 GEMM per pair
     (ns(ns+1)/2, all of one shape), one int32 total per t-group.  The
     schedule's group chunking guarantees no int32 overflow
     (schedule.group_schedule).  At large shapes the pairs run in a
     loop that indexes the digit planes, so one pair product and one
     group total are live at a time, whatever order the compiler would
     give unrolled GEMMs.

  2. Each group's int32 result is split exactly into two f32 terms
     (high/low 16-bit halves) and folded into a triple-float32 accumulator
     (~71-bit) in ascending-t order — deterministic, and strictly more
     accurate than the reference's per-step f64 rounding
     (gemm.cu:77-102).

Scaling: accumulation happens in a ``2^ACC_SHIFT``-biased space so every
f32 component stays inside the normal-number range (a backend that
flushes denormals — XLA:CPU does — and one that keeps them then agree
bitwise).  ``ACC_SHIFT = b*(ns+1) - 64`` puts the smallest group weight
at exactly 2^-62 and the largest possible head magnitude at
``2^(b(ns-1) - 31) <= 2^88``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..schedule import group_schedule
from . import tf32x3

Triple = tf32x3.Triple


def acc_shift(num_split: int, b: int) -> int:
    """Exponent bias of the accumulation space (see module docstring)."""
    return b * (num_split + 1) - 64


def _pair_dot(da: jax.Array, db: jax.Array, i, j) -> jax.Array:
    """``A_i @ B_j`` in int32 for 0-based (possibly traced) plane indices.

    ``da``: int8 [ns, m, k]; ``db``: int8 [ns, k, n].  Every pair GEMM
    has the same [m, k] x [k, n] shape, so XLA compiles (and autotunes)
    one GEMM for the whole schedule.
    """
    return jax.lax.dot_general(
        jax.lax.dynamic_index_in_dim(da, i, keepdims=False),
        jax.lax.dynamic_index_in_dim(db, j, keepdims=False),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


#: int32 product size (bytes) from which the slice pairs run in a loop.
#: Smaller products are unrolled: all of them fit easily, and XLA:GPU
#: pays a host round trip per loop iteration.  (XLA:CPU also miscompiles
#: some tiny s8 dots inside loops, e.g. 4x8 @ 8x4.)
LOOP_MIN_BYTES = 1 << 20


def _looped(da: jax.Array, db: jax.Array) -> bool:
    return 4 * da.shape[1] * db.shape[2] >= LOOP_MIN_BYTES


def _group_dot(da: jax.Array, db: jax.Array, pairs) -> jax.Array:
    """Sum of A_i @ B_j over the group's pairs, in exact int32 (the
    schedule's cap keeps it exact, so the order of the additions does
    not matter)."""
    if not _looped(da, db):
        return sum(_pair_dot(da, db, i - 1, j - 1) for i, j in pairs)
    ia = jnp.asarray([i - 1 for i, _ in pairs], jnp.int32)
    ib = jnp.asarray([j - 1 for _, j in pairs], jnp.int32)
    zero = jnp.zeros((da.shape[1], db.shape[2]), jnp.int32)
    return jax.lax.fori_loop(
        0, len(pairs), lambda p, t: t + _pair_dot(da, db, ia[p], ib[p]), zero
    )


def _fold(acc: Triple, d, scale_hi, scale_lo) -> Triple:
    """Add the int32 total ``d`` times the power of two ``scale_lo`` to
    the accumulator, split exactly into two f32 terms (the high and low
    16-bit halves; ``scale_hi = scale_lo * 2^16``).  Both products are
    exact, so a constant or a traced scale gives the same bits."""
    hi = jax.lax.shift_right_arithmetic(d, np.int32(16))  # [-2^15, 2^15)
    lo = d - jax.lax.shift_left(hi, np.int32(16))  # [0, 2^16)
    acc = tf32x3.add_term(acc, hi.astype(jnp.float32) * scale_hi)
    return tf32x3.add_term(acc, lo.astype(jnp.float32) * scale_lo)


def _scales(num_split: int, k: int, b: int):
    """(scale_hi, scale_lo) f32 weights of every scheduled group."""
    shift = acc_shift(num_split, b)
    ws = [g.weight_log2(b) + shift for g in group_schedule(num_split, k, b)]  # >= -62
    return (np.array([2.0 ** (w + 16) for w in ws], np.float32),
            np.array([2.0**w for w in ws], np.float32))


@partial(jax.jit, static_argnums=(2, 3, 4), inline=True)
def recombine(
    da: jax.Array,
    db: jax.Array,
    num_split: int,
    b: int,
    k: int,
) -> Triple:
    """Weighted recombination of all scheduled slice pairs.

    Returns the triple-f32 accumulator ``S_shifted`` [m, n] such that the
    mathematical partial result is::

        sum_{i+j<=ns+1} (A_i @ B_j) * 2^(2 - b(i+j))
            == S_shifted * 2^(-ACC_SHIFT)

    The caller folds ``2^(pa + pb + ACC_SHIFT^-1)`` in the epilogue.
    Bitwise equal to ``fold_group_totals(group_totals(...))``; from
    :data:`LOOP_MIN_BYTES` on, one loop over the groups (ascending t),
    each an inner loop over its pairs followed by the fold, so one pair
    product, one group total and the accumulator are live.
    """
    if not _looped(da, db):
        return fold_group_totals(group_totals(da, db, num_split, k, b), num_split, k, b)
    groups = group_schedule(num_split, k, b)
    ia = jnp.asarray([i - 1 for g in groups for i, _ in g.pairs], jnp.int32)
    ib = jnp.asarray([j - 1 for g in groups for _, j in g.pairs], jnp.int32)
    stops = np.cumsum([len(g.pairs) for g in groups]).astype(np.int32)
    starts = stops - np.array([len(g.pairs) for g in groups], np.int32)
    s_hi, s_lo = _scales(num_split, k, b)
    zero = jnp.zeros((da.shape[1], db.shape[2]), jnp.int32)

    def group(acc, g):
        start, stop, sh, sl = g
        d = jax.lax.fori_loop(
            start, stop, lambda p, t: t + _pair_dot(da, db, ia[p], ib[p]), zero
        )
        return _fold(acc, d, sh, sl), None

    acc, _ = jax.lax.scan(
        group, tf32x3.zeros(zero.shape), (starts, stops, s_hi, s_lo)
    )
    return tf32x3.renorm(acc)


def group_totals(da, db, num_split: int, k: int, b: int):
    """Int32 partial products of every scheduled t-group (a list, in
    ascending-t schedule order).  Exact — summable across k-shards or
    k-chunks without overflow (the schedule's chunk cap bounds the FULL
    contraction; pass the GLOBAL k)."""
    return [
        _group_dot(da, db, g.pairs) for g in group_schedule(num_split, k, b)
    ]


def fold_group_totals(totals, num_split: int, k: int, b: int) -> Triple:
    """Deterministic fold of the int32 group totals into the triple-f32
    accumulator (ascending t; each total split exactly into two f32
    16-bit-half terms)."""
    acc = tf32x3.zeros(totals[0].shape)
    for d, sh, sl in zip(totals, *_scales(num_split, k, b)):
        acc = _fold(acc, d, sh, sl)
    return tf32x3.renorm(acc)
