"""Device-side mantissa split: exact f64 bits -> sign-magnitude int8 planes.

Re-derivation of the reference split kernel (src/split.cu:154-242):
instead of CUDA warp reductions over a 128-bit temporary, the 53-bit
significand is carried as two uint32 words (from the
:class:`~ozimmu_tpu.core.f64x.F64X` bit planes) and each b-bit digit window
is extracted with a branch-free 32-bit funnel shift — all int32
elementwise ops, no f64 arithmetic anywhere.  XLA fuses the whole split
(the row-max reduction aside) into one elementwise kernel over the
``[ns, rows, cols]`` plane tensor.

Semantics parity with the reference:
  * per-row max exponent, doubled (``x2``, split.cu:187-204):
    row scale is ``2^(Erow - 1022)``;
  * digit ``i`` (1-indexed) is bits ``[r, r+b)`` of the significand where
    ``r = 53 + (Erow + 1 - E) - i*b`` (split.cu:154-185);
  * exponent-field-0 elements keep their raw mantissa with no implicit
    bit (split.cu:160-162); rows whose max exponent field is 0 produce
    zero digits and a nulled row scale (split.cu:203).

Exactness identity (tested in tests/test_device_split.py):

    x[r, c] == 2^pexp[r] * sum_i digits[i-1, r, c] * 2^(1 - i*b)

whenever ``ns*b >= 53 + (Erow - E)``.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.f64x import F64X, exponent_field, mantissa_parts

#: pexp value for all-zero/subnormal rows; any int that the pack kernel's
#: exponent clamp turns into a hard underflow (exact 0.0).
ZERO_ROW_PEXP = np.int32(-(2**20))


def row_exponent(x: F64X, axis: int = 1) -> jax.Array:
    """Max biased exponent field along the contraction axis of the local
    shard.  In a k-sharded distributed setting, combine across shards with
    ``lax.pmax`` before calling :func:`split_with_row_exp`."""
    return jnp.max(exponent_field(x), axis=axis)


def split_with_row_exp(
    x: F64X, e_row: jax.Array, num_split: int, b: int, axis: int = 1
) -> Tuple[jax.Array, jax.Array]:
    """Split against an externally supplied (possibly global) max exponent
    along ``axis`` (the contraction axis).  See :func:`split_f64x`.

    ``axis=1``: x is [rows, k], one scale per row (the A operand).
    ``axis=0``: x is [k, cols], one scale per column (the B operand) —
    digits come out in the matrix's natural layout, avoiding the large
    int8 plane transposes a row-only kernel would force.
    """
    e = exponent_field(x)  # int32, biased
    m_hi, m_lo = mantissa_parts(x)  # uint32: 21-bit, 32-bit words
    sign_neg = (x.hi >> np.uint32(31)).astype(jnp.int32)  # 1 if sign bit set
    # reference split.cu:159: sign_flag = (a > 0); zeros (a==0) take the
    # negative branch but have zero digits, so only the sign bit matters.
    dsign = jnp.where(sign_neg == 1, np.int32(-1), np.int32(1))
    nonzero_row = e_row > 0
    pexp = jnp.where(nonzero_row, e_row - 1022, ZERO_ROW_PEXP).astype(jnp.int32)

    bcast = (slice(None), None) if axis == 1 else (None, slice(None))
    delta = (e_row + 1)[bcast] - e  # >= 1 where the scale group is nonzero
    mask = np.uint32((1 << b) - 1)

    # All ns digit windows extracted as ONE vectorized op over a leading
    # plane axis (like the estimator's candidate axis, ops/mantissa_loss):
    # the expensive loads (mantissa words, delta) are shared across planes
    # in a single fusion instead of ns separate loop nests + stack.  Also
    # sidesteps a nondeterministic-wrong-results bug in XLA:CPU's fused
    # ragged loop partitioning (multi-device CPU clients on few-core
    # hosts; observed: the per-plane-loop form corrupts partition-boundary
    # elements, e.g. row k/2 at [250, 9] — same executable, flip-flopping
    # results).  Bitwise-identical either way (exact integer ops).
    ii = (np.arange(1, num_split + 1, dtype=np.int32) * np.int32(b))[:, None, None]
    r = (53 + delta)[None, :, :] - ii  # [ns, rows, cols] window LSB position
    # clamp into shift-legal ranges; semantics preserved because
    # m53 < 2^53 (r>=53 -> 0) and windows below bit -b are all zero.
    r_hi = jnp.clip(r - 32, 0, 31).astype(jnp.uint32)
    r_lo = jnp.clip(r, 0, 31).astype(jnp.uint32)
    l_hi = jnp.clip(32 - r, 1, 31).astype(jnp.uint32)
    l_neg = jnp.clip(-r, 0, 31).astype(jnp.uint32)

    m_hi, m_lo = m_hi[None], m_lo[None]
    from_hi = (m_hi >> r_hi) & mask  # window entirely in the high word
    straddle = ((m_hi << l_hi) | (m_lo >> r_lo)) & mask
    from_neg = (m_lo << l_neg) & mask  # window extends below bit 0

    win = jnp.where(
        r >= 53,
        np.uint32(0),
        jnp.where(
            r >= 32,
            from_hi,
            jnp.where(r >= 0, straddle, jnp.where(r > -b, from_neg, np.uint32(0))),
        ),
    )
    digits = (win.astype(jnp.int32) * dsign[None]).astype(jnp.int8)
    digits = jnp.where(nonzero_row[(None,) + bcast], digits, np.int8(0))
    return digits, pexp


def _split(x: F64X, num_split: int, b: int, axis: int):
    return split_with_row_exp(x, row_exponent(x, axis), num_split, b, axis=axis)


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def split_f64x(x: F64X, num_split: int, b: int) -> Tuple[jax.Array, jax.Array]:
    """Split ``x`` [rows, k] into digit planes.

    Returns ``(digits, pexp)``: ``digits`` int8 ``[ns, rows, k]``, ``pexp``
    int32 ``[rows]`` with row scale ``2^pexp``.
    """
    return _split(x, num_split, b, axis=1)


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def split_f64x_cols(x: F64X, num_split: int, b: int) -> Tuple[jax.Array, jax.Array]:
    """Split ``x`` [k, cols] along columns (for the B operand).

    Computed as the row-wise split of ``x.T`` (reference split.cu:277-282
    swaps m/n and the op).  Returns digits int8 ``[ns, k, cols]`` and
    pexp int32 [cols]; XLA is free to keep the planes k-minor, the layout
    the int8 GEMMs read, so the only transposes are of the u32 inputs.
    """
    d, p = _split(F64X(x.hi.T, x.lo.T), num_split, b, axis=1)
    return jnp.swapaxes(d, 1, 2), p
