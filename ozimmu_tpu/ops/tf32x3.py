"""Triple-float32 expansion arithmetic (~71-bit significand).

The recombination and epilogue of the Ozaki engine accumulate in more
significand than float64 holds: the reference accumulates partial
products in hardware f64 (reference src/gemm.cu:77-102,124-158) and
rounds at every step.  This module implements an unevaluated
sum of three float32 components — a "triple-float" in the style of
double-double/quad-double expansion arithmetic (Dekker 1971, Hida-Li-Bailey
QD) — giving ~71 bits, comfortably above f64's 53.

Every primitive here uses only IEEE round-to-nearest f32 add/sub/mul.  No
FMA is assumed: exact products use Dekker splitting.  Denormal flushing
(XLA:CPU flushes, XLA:GPU does not) is kept out of the results by keeping
operand magnitudes in safe exponent ranges (see ops/recombine.py
ACC_SHIFT).

All functions operate elementwise on jnp.float32 arrays and are shape-
polymorphic.  A triple is a tuple ``(s0, s1, s2)`` with ``|s0| >= |s1| >=
|s2|`` after renormalization.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Triple = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]

_HI12 = np.int32(-4096)  # 0xFFFFF000: sign, exponent and 11 leading fraction bits


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (no magnitude ordering)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Fast TwoSum requiring |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def f32_split(a):
    """a == hi + lo exactly, ``hi`` the leading 12 significand bits (bit
    masking — no multiply) and ``lo`` the remaining <= 12."""
    bits = jax.lax.bitcast_convert_type(a, jnp.int32) & _HI12
    hi = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return hi, a - hi


def prod_terms(a, b):
    """Four f32 terms whose exact sum is ``a * b``; each term is a
    product of two <= 12-bit halves, so it is computed EXACTLY (barring
    under/overflow)."""
    ah, al = f32_split(a)
    bh, bl = f32_split(b)
    return ah * bh, ah * bl, al * bh, al * bl


def zeros(shape) -> Triple:
    z = jnp.zeros(shape, dtype=jnp.float32)
    return (z, z, z)


def renorm(t: Triple) -> Triple:
    """Renormalize so components are non-overlapping, descending magnitude."""
    s, e2 = quick_two_sum(t[1], t[2])
    s0, e1 = quick_two_sum(t[0], s)
    s1, s2 = quick_two_sum(e1, e2)
    s0, s1 = quick_two_sum(s0, s1)
    return (s0, s1, s2)


def add_term(acc: Triple, x) -> Triple:
    """Accumulate one exactly-representable f32 term into the triple.

    Grows the expansion with a TwoSum cascade; error is confined below the
    third component (~2^-71 relative to the head).
    """
    s0, e0 = two_sum(acc[0], x)
    s1, e1 = two_sum(acc[1], e0)
    s2 = acc[2] + e1
    return (s0, s1, s2)


def add(x: Triple, y: Triple) -> Triple:
    """Triple + triple (components merged head-first, then renormalized)."""
    a = add_term(x, y[0])
    a = add_term(a, y[1])
    a = add_term(a, y[2])
    return renorm(a)


def neg(x: Triple) -> Triple:
    return (-x[0], -x[1], -x[2])


def mul(x: Triple, y: Triple) -> Triple:
    """Triple * triple to ~70-bit accuracy.

    Keeps all O(eps^2) cross terms; drops O(eps^3) ones (x1*y2 etc.).
    Every product is split into exact partial products
    (:func:`prod_terms`) and only additions round, so a compiler that
    contracts a multiply and an add into one FMA (XLA:GPU does) computes
    the same bits as one that does not.
    """
    acc = zeros(jnp.shape(x[0]))
    for a, b in ((x[0], y[0]), (x[0], y[1]), (x[1], y[0]),
                 (x[1], y[1]), (x[0], y[2]), (x[2], y[0])):
        for term in prod_terms(a, b):
            acc = add_term(acc, term)
    return renorm(acc)


def scale_exact(x: Triple, s) -> Triple:
    """Multiply by an exact power-of-two float32 scalar/array (exact)."""
    return (x[0] * s, x[1] * s, x[2] * s)


def pow2_f32(e):
    """2^e as float32 built from exponent bits; e int32 in [-126, 127]."""
    bits = ((e + 127).astype(jnp.int32) << 23).astype(jnp.int32)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def scale_pow2(x: Triple, e) -> Triple:
    """Multiply triple by 2^e for int32 ``e`` (elementwise), |e| <= ~250.

    Applied in two half-steps so each factor stays inside f32's normal
    exponent range; magnitudes that still over/underflow saturate to
    inf/0, which callers rely on for drop semantics in aligned adds.
    """
    e = jnp.asarray(e, dtype=jnp.int32)
    h1 = jnp.clip(e // 2, -126, 127)
    h2 = jnp.clip(e - h1, -126, 127)
    s1 = pow2_f32(h1)
    s2 = pow2_f32(h2)
    return (x[0] * s1 * s2, x[1] * s1 * s2, x[2] * s1 * s2)


def to_f32(x: Triple):
    return x[0] + x[1] + x[2]


def from_f64_host(v: float) -> Tuple[Tuple[float, float, float], int]:
    """Host-side exact decomposition of a python float:
    ``v = (t0 + t1 + t2) * 2^E`` with f32 components, |t0| in [1, 2).

    Used for static alpha/beta scalars.
    """
    import math

    if v == 0.0:
        return ((0.0, 0.0, 0.0), 0)
    if not math.isfinite(v):
        raise ValueError(f"alpha/beta must be finite, got {v}")
    mant, exp = math.frexp(v)  # v = mant * 2^exp, |mant| in [0.5, 1)
    mant *= 2.0
    exp -= 1  # |mant| in [1, 2)
    t0 = np.float32(mant)
    r = mant - float(t0)
    t1 = np.float32(r)
    r -= float(t1)
    t2 = np.float32(r)
    # 53-bit mantissa always fits in three 24-bit components exactly
    assert float(t0) + float(t1) + float(t2) == mant
    return ((float(t0), float(t1), float(t2)), exp)
