"""Mantissa-loss estimation and AUTO split-count selection.

Re-derivation of the reference estimator (src/split.cu:300-518):
per element, the mantissa space needed for an error-free split is
``(row_max_exponent_doubled - exponent) + 53`` bits; with ``ns`` slices of
``b`` bits each, ``loss(ns) = max(0, required - ns*b)``.  The totals over
both operands, averaged per element, drive mode selection: the smallest
``ns`` whose average loss is within threshold wins, else fall back to
native ``dgemm`` (split.cu:453-494).

Fixes carried over from the survey: the reference allocates 8 counter
slots but writes 16 (handle.hpp:22 vs split.cu:397) — a device OOB.  Here
the counter vector is sized from the mode range (16 slots for ns=3..18).

Instead of an ``atomicAdd`` kernel per operand, the whole loss
table for all 16 candidate split counts is one jitted int32 reduction over
the exponent field (the expensive part, the exponent load, is shared
across all candidates).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.f64x import F64X, exponent_field
from ..schedule import bits_per_int8
from ..types import MAX_NUM_SPLIT, MIN_NUM_SPLIT, ComputeMode

_NS_CANDIDATES = np.arange(MIN_NUM_SPLIT, MAX_NUM_SPLIT + 1, dtype=np.int32)


def loss_totals_with_group_exp(
    x: F64X, e_group: jax.Array, b: int, axis: int
) -> jax.Array:
    """Loss totals for ns = 3..18 of ``x`` against an externally-supplied
    scale-group max exponent field ``e_group`` (shape = ``x`` minus
    ``axis``).

    This is the traceable core shared by the single-chip estimator (local
    group max) and the distributed estimator (``lax.pmax``-combined global
    group max, parallel/gemm.sharded_loss_totals_fn) — the same split in
    the split kernel itself (ops.split.split_with_row_exp).  Returns the
    PARTIAL totals over the elements of ``x`` only; the caller sums
    partials across shards (exact int64, order-independent).
    """
    e = exponent_field(x)  # [rows, k] or [k, cols]
    mant_nonzero = (
        (x.hi & np.uint32(0x000FFFFF)) | x.lo
    ) != 0
    value_nonzero = (e > 0) | mant_nonzero
    row_ok = e_group > 0
    bcast = (slice(None), None) if axis == 1 else (None, slice(None))

    required = (e_group[bcast] + 1 - e) + 53  # int32
    valid = value_nonzero & row_ok[bcast]
    required = jnp.where(valid, required, 0)

    space = (_NS_CANDIDATES * np.int32(b))[:, None, None]  # [16,1,1]
    loss = jnp.maximum(required[None, :, :] - space, 0)
    loss = jnp.where(valid[None, :, :], loss, 0)
    return jnp.sum(loss.astype(jnp.int64), axis=(1, 2))


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def mantissa_loss_totals(x: F64X, b: int, axis: int = 1) -> jax.Array:
    """Loss totals for ns = 3..18 over scale groups of ``x``.

    ``axis`` is the contraction axis: 1 for A [rows, k] (per-row scale),
    0 for B [k, cols] (per-column scale, computed in natural layout — no
    transpose relayout).  Returns int64 [16].  Elements with value exactly
    zero and groups whose max exponent field is zero are skipped
    (reference split.cu:322-324).
    """
    e_group = jnp.max(exponent_field(x), axis=axis)
    return loss_totals_with_group_exp(x, e_group, b, axis)


def auto_fallback_mode() -> ComputeMode:
    """The mode AUTO falls back to when even ns=18 exceeds the loss
    threshold: native ``DGEMM``, as in the reference (split.cu:473-493,
    gemm.cu:639-645).  Every backend JAX runs on (CPU, NVIDIA GPU) has
    IEEE float64, so the native product is exact-to-rounding and needs
    one GEMM instead of the 171 int8 products of ``fp64_int8_18``.

    Override with ``OZIMMU_AUTO_FALLBACK=int8_18`` (``dgemm`` = the
    default).
    """
    import os

    raw = os.environ.get("OZIMMU_AUTO_FALLBACK", "dgemm").lower()
    if raw in ("int8_18", "deepest"):
        return ComputeMode.FP64_INT8_18
    return ComputeMode.DGEMM


def select_mode_from_totals(totals, denom: float, threshold: float) -> ComputeMode:
    """The reference selection loop (split.cu:473-493): smallest ns whose
    AVERAGE loss (``totals[ns] / denom``) is within threshold, else the
    fallback (:func:`auto_fallback_mode`).  Shared by every AUTO surface
    — host API, batched, interceptor, and the distributed estimator."""
    totals = np.asarray(totals)
    for idx, ns in enumerate(_NS_CANDIDATES):
        if totals[idx] / denom <= threshold:
            return ComputeMode.from_num_split(int(ns))
    return auto_fallback_mode()


def complex_loss_totals(
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    k: int,
    b_is_cols: bool = True,
) -> jax.Array:
    """ONE shared loss counter over all four re/im planes — the reference
    complex estimator semantics (split.cu:69-152 feeding 300-518): the
    complex kernel accumulates the losses of both parts of every element
    into the same per-mode counter.  Returns int64 [16].

    Deliberate deviation (documented): scale groups are per-PLANE row/col
    maxima, matching this engine's complex split (core/gemm._zgemm_core
    splits the four planes independently), where the reference shares one
    row max across re/im (its side-by-side slice layout requires it,
    split.cu:211-216).  Per-plane maxima never report MORE loss than the
    engine actually incurs.
    """
    bb = bits_per_int8(k)
    b_axis = 0 if b_is_cols else 1
    return (
        mantissa_loss_totals(a_re, bb, 1)
        + mantissa_loss_totals(a_im, bb, 1)
        + mantissa_loss_totals(b_re, bb, b_axis)
        + mantissa_loss_totals(b_im, bb, b_axis)
    )


def auto_mode_select_complex(
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    k: int,
    threshold: float,
    b_is_cols: bool = True,
) -> ComputeMode:
    """Complex AUTO selection from the single shared counter.

    The average divides by the total number of REAL plane elements,
    ``2 * (m*k + k*n)`` — identical semantics on every surface (host API,
    batched, interceptor eager and traced), per VERDICT r2 item 3.
    """
    totals = jax.device_get(
        complex_loss_totals(a_re, a_im, b_re, b_im, k, b_is_cols)
    )
    m = a_re.shape[0]
    n = b_re.shape[1] if b_is_cols else b_re.shape[0]
    return select_mode_from_totals(totals, 2.0 * (m * k + k * n), threshold)


def auto_mode_select(
    a: F64X,
    b_mat: F64X,
    k: int,
    threshold: float,
    b_is_cols: bool = True,
) -> ComputeMode:
    """Pick the smallest adequate split count, else fall back to DGEMM.

    ``a`` is [m, k]; ``b_mat`` is [k, n] when ``b_is_cols`` (split along
    columns, i.e. over B^T rows) — matching reference split.cu:464-471.
    Mirrors the selection loop of split.cu:473-493.
    """
    bb = bits_per_int8(k)
    la = mantissa_loss_totals(a, bb, axis=1)
    lb = mantissa_loss_totals(b_mat, bb, axis=0 if b_is_cols else 1)
    totals = jax.device_get(la + lb)
    m = a.shape[0]
    n = b_mat.shape[1] if b_is_cols else b_mat.shape[0]
    return select_mode_from_totals(totals, float(m * k + k * n), threshold)
