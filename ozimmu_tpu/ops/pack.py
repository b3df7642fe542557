"""Rounding and bit assembly between triple-f32 values and exact IEEE f64.

The engine's result exists on device as ``(triple-f32 mantissa, int32
exponent)`` per element.  This module rounds that ~71-bit value to the
nearest IEEE-754 binary64 and assembles the (hi, lo) uint32 bit planes of
:class:`~ozimmu_tpu.core.f64x.F64X` — the counterpart of the reference's
f64 epilogue kernels (``axby`` src/gemm.cu:124-158, ``axy_complex``
gemm.cu:160-197), with one rounding instead of one per step.

Everything uses native int32/f32 plus (emulated) int64 shifts; correctness
is validated bit-for-bit against numpy on the CPU backend, where all JAX
dtypes are true IEEE.

Rounding contract: round-to-nearest-even (IEEE default).  The packed
result is the CORRECTLY ROUNDED f64 of the exact triple-f32 accumulator
value ``(t0+t1+t2) * 2^E``: the tails fold into the guard-space
significand through composed ROUND-TO-ODD shifts (each >= 2 bits above
the next rounding position — the Boldo-Melquiond double-rounding-safe
pattern), then ONE round-to-nearest-even lands on the target precision
(normal or subnormal).  The only residual error vs infinitely-precise
arithmetic is the ~2^-71 accumulation error of the triple itself, which
is strictly inside the reference's per-step f64 rounding envelope
(gemm.cu:77-102 rounds every one of ns(ns+1)/2 partial-product
accumulations to f64).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.f64x import F64X, exponent_field, mantissa_parts
from . import tf32x3

Triple = tf32x3.Triple

_F32_MANT = np.int32(0x7FFFFF)
_F32_IMPL = np.int32(1 << 23)


def _f32_fields(x: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(sign(+1/-1), exponent field, significand int incl. implicit bit).

    f32 subnormals (ef == 0) carry their raw mantissa with no implicit
    bit — the same significand formula as ef == 1 — so tail components
    that underflowed to subnormal still contribute exactly (pack_f64x
    reads their exponent as ``max(ef, 1)``).  The engine keeps its
    accumulator components in normal range (ops/recombine.py ACC_SHIFT),
    so on a backend that flushes f32 denormals in arithmetic this path
    only ever sees zeros; where they survive it makes pack exact for
    out-of-envelope inputs too.
    """
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    sgn = jnp.where(bits < 0, np.int32(-1), np.int32(1))
    ef = (bits >> 23) & np.int32(0xFF)
    m = (bits & _F32_MANT) | jnp.where(ef > 0, _F32_IMPL, np.int32(0))
    return sgn, ef, m


def unpack_f64x(c: F64X) -> Tuple[Triple, jax.Array]:
    """Exact decomposition: value(c) == (t0 + t1 + t2) * 2^E.

    Components are exact f32 (21 + 16 + 16 significand bits); ``E`` is
    int32.  Works for normals, subnormals and zeros; NaN/Inf are out of
    the engine's contract (as in the reference).
    """
    field = exponent_field(c)
    m_hi, m_lo = mantissa_parts(c)  # uint32 (21-bit incl implicit, 32-bit)
    sgn = jnp.where((c.hi >> np.uint32(31)) == 1, np.float32(-1), np.float32(1))
    E = jnp.where(field > 0, field, 1) - np.int32(1075)
    l_hi = (m_lo >> np.uint32(16)).astype(jnp.float32)
    l_lo = (m_lo & np.uint32(0xFFFF)).astype(jnp.float32)
    t0 = m_hi.astype(jnp.float32) * np.float32(2.0**32)
    t1 = l_hi * np.float32(2.0**16)
    t2 = l_lo
    return (t0 * sgn, t1 * sgn, t2 * sgn), E.astype(jnp.int32)


def _rto_shift(v, s):
    """Arithmetic shift right by ``s`` with ROUND TO ODD: the result's
    low bit is forced to 1 whenever any shifted-out bit was nonzero.

    Round-to-odd is the double-rounding-safe intermediate (Boldo &
    Melquiond): a subsequent round-to-nearest at a position >= 2 bits
    coarser yields exactly the correctly rounded value of the original.
    Works on signed two's complement: floor-shift brackets the value
    from below and ``| 1`` picks the odd representative of the open
    bracket in either sign.
    """
    c = jax.lax.shift_right_arithmetic(v, s)
    inexact = jax.lax.shift_left(c, s) != v
    return jnp.where(inexact, c | jnp.int64(1), c)


def _rne_shift(q, s):
    """``round(q / 2^s)`` with ties to even; ``q`` int64 >= 0 carries
    round-to-odd sticky information in its low bit, ``s`` in [2, 62].

    Exactness: if the value q represents was inexact below bit 0, bit 0
    is odd, so ``rem`` can never equal the (even) half point — strict
    comparisons then decide correctly; a true tie has exact q and breaks
    on the target's parity.
    """
    one = jnp.int64(1)
    rem = q & (jax.lax.shift_left(one, s) - one)
    half = jax.lax.shift_left(one, s - 1)
    base = jax.lax.shift_right_logical(q, s)
    up = (rem > half) | ((rem == half) & ((base & one) == one))
    return base + jnp.where(up, one, jnp.int64(0))


def pack_f64x(t: Triple, E: jax.Array) -> F64X:
    """Round ``(t0+t1+t2) * 2^E`` to nearest f64 (ties to even) and emit
    IEEE bit planes.

    Handles normals, carries across the power-of-two boundary, subnormal
    outputs (single rounding straight from the accumulator — no double
    rounding) and overflow to inf.
    """
    t = tf32x3.renorm(t)
    E = jnp.asarray(E, dtype=jnp.int32)

    s0, ef0, m0 = _f32_fields(t[0])
    s1, ef1, m1 = _f32_fields(t[1])
    s2, ef2, m2 = _f32_fields(t[2])
    is_zero = ef0 == 0  # head is zero/denormal-f32 -> result 0

    # Guard-space significand: q ~ |v| * 2^(55 - e0) (3 guard bits below
    # the 53-bit target), v = t0+t1+t2, e0 = floor(log2|t0|).  The head
    # contributes m0 << 32 exactly.  The two tails fold in EXACTLY via
    # two composed round-to-odd steps: the smaller tail is rto-shifted
    # into the larger tail's frame, their sum is rto-shifted into q's
    # frame, and the final round-to-nearest-even happens >= 2 bits above
    # q's bit 0 — by the round-to-odd composition theorem the result is
    # the correctly rounded value of the exact triple, for ANY gaps
    # (renorm guarantees the >= 2-bit spacing each step needs: tails sit
    # >= 23 binades apart from their predecessor, except at the very
    # bottom of the f32 subnormal range where the folds are exact anyway).
    neg = s0 < 0

    def rel(sgn_i, m_i):  # tail significand, signed relative to the head
        sc = m_i.astype(jnp.int64) << 32
        return jnp.where((sgn_i * s0) < 0, -sc, sc)

    # order the tails by magnitude frame (renorm emits |t1| >= |t2|, but
    # crafted inputs may not honor it and the swap is cheap)
    e1 = jnp.maximum(ef1, 1)
    e2 = jnp.maximum(ef2, 1)
    swap = e2 > e1
    ef_a = jnp.where(swap, e2, e1)
    ef_b = jnp.where(swap, e1, e2)
    sc_a = jnp.where(swap, rel(s2, m2), rel(s1, m1))
    sc_b = jnp.where(swap, rel(s1, m1), rel(s2, m2))

    d = jnp.clip(ef_a - ef_b, 0, 62).astype(jnp.int64)  # frames b -> a
    gap = jnp.clip(ef0 - ef_a, 0, 62).astype(jnp.int64)  # frame a -> q
    s12 = sc_a + _rto_shift(sc_b, d)  # |.| < 2^58, exact sum
    q = (m0.astype(jnp.int64) << 32) + _rto_shift(s12, gap)

    # If cancellation dropped the UNROUNDED value below 2^(e0) (i.e. q
    # below 2^55), the target scale is one binade down (one fewer guard
    # bit).  Decided on the floor, NOT the rounded value: a value just
    # under the binade boundary must round within the lower binade's
    # finer ulp (e.g. 2^52 - 0.5 is exactly representable there).  The
    # rto low bit cannot flip this test: it only fires on inexact q,
    # whose floor is then strictly inside one side of the boundary.
    need_down = q < (jnp.int64(1) << 55)
    e0 = (ef0 - 127) - jnp.where(need_down, 1, 0)

    Ef = e0 + E + np.int32(1023)  # biased f64 exponent (pre-carry)
    is_inf = Ef >= 2047  # outright overflow (pre-carry; carry handled below)
    Ef_c = jnp.clip(Ef, -1, 2046)  # keep the int64 shift in range

    # Total right-shift from q to the target significand: 3 guard bits
    # (2 when cancellation moved the scale down) plus the subnormal
    # underflow shift — applied in ONE rounding, directly from q.  The
    # minimum shift of 2 is what licenses the round-to-odd folds above.
    r = jnp.clip(1 - Ef, 0, 62).astype(jnp.int64)
    s_eff = jnp.where(need_down, jnp.int64(2), jnp.int64(3))
    st = jnp.clip(s_eff + r, 2, 62)
    q_final = _rne_shift(q, st)
    is_sub = Ef <= 0

    # Assemble by addition so mantissa carries ripple into the exponent:
    # q_final == 2^53 after rounding -> exponent += 1 (2046 carries to the
    # inf encoding, which is exactly right); subnormal rounding up to 2^52
    # -> smallest normal.
    bits_normal = (Ef_c.astype(jnp.int64) << 52) + (q_final - (jnp.int64(1) << 52))
    bits = jnp.where(is_sub, q_final, bits_normal)
    bits = jnp.where(is_inf, jnp.int64(2047) << 52, bits)
    bits = jnp.where(is_zero, jnp.int64(0), bits)

    # sign applies to zeros too (preserves IEEE -0.0 through a round trip)
    sign64 = jnp.where(neg, jnp.int64(1) << 63, jnp.int64(0))
    bits = bits | sign64
    hi = (bits >> 32).astype(jnp.uint32)
    lo = jax.lax.convert_element_type(bits & np.int64(0xFFFFFFFF), jnp.uint32)
    return F64X(hi, lo)


def aligned_add(x: Triple, xE: jax.Array, y: Triple, yE: jax.Array) -> Tuple[Triple, jax.Array]:
    """(x * 2^xE) + (y * 2^yE) as (triple, exponent).

    Both operands are rescaled to the elementwise max exponent; a term
    more than ~250 binades below the other underflows to zero in f32 —
    the correct drop semantics (f64 rounding ignores terms >54 binades
    apart anyway).
    """
    m = jnp.maximum(xE, yE)
    dx = jnp.clip(xE - m, -300, 0)
    dy = jnp.clip(yE - m, -300, 0)
    xs = tf32x3.scale_pow2(x, dx)
    ys = tf32x3.scale_pow2(y, dy)
    return tf32x3.add(xs, ys), m


def scalar_triple(v: float, shape=()) -> Tuple[Triple, int]:
    """Static python float -> broadcast triple + exponent (exact)."""
    (t0, t1, t2), e = tf32x3.from_f64_host(v)
    mk = lambda c: jnp.full(shape, c, dtype=jnp.float32)
    return (mk(t0), mk(t1), mk(t2)), e
