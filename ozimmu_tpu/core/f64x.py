"""Exact float64 carriage: IEEE-754 bits as two uint32 planes.

``F64X`` carries the raw IEEE-754 bit pattern of a float64 array as two
uint32 arrays (hi = sign/exponent/mantissa-high, lo = mantissa-low).  The
engine's split, recombination and epilogue work on these bits with
integer and float32 operations only, so every backend computes them
bit-identically; host conversion is a free numpy view and device
conversion one bitcast (:func:`from_f64` / :func:`to_f64`).

The reference engine has no analogue — it reads the f64 operands in its
split kernel directly (reference src/split.cu:154-185).  Removing this
carriage in favour of int64 bitcasts inside the kernels is open design
work (ROADMAP D1).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class F64X:
    """Exact float64 tensor as IEEE bit planes (hi, lo), both uint32."""

    hi: jax.Array
    lo: jax.Array

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- properties ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.hi.shape)

    @property
    def ndim(self) -> int:
        return self.hi.ndim

    # -- conversions -----------------------------------------------------
    @classmethod
    def from_numpy(cls, x: np.ndarray) -> "F64X":
        """Exact host conversion (a bit-level view; no rounding)."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        bits = x.view(np.uint64)
        hi = (bits >> np.uint64(32)).astype(np.uint32)
        lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return cls(jnp.asarray(hi), jnp.asarray(lo))

    def to_numpy(self) -> np.ndarray:
        """Exact host conversion back to numpy float64."""
        hi = np.asarray(jax.device_get(self.hi), dtype=np.uint64)
        lo = np.asarray(jax.device_get(self.lo), dtype=np.uint64)
        return ((hi << np.uint64(32)) | lo).view(np.float64)

    @classmethod
    def from_scalar(cls, v: float) -> "F64X":
        return cls.from_numpy(np.array(v, dtype=np.float64).reshape(()))

    def transpose(self) -> "F64X":
        return F64X(self.hi.T, self.lo.T)

    def reshape(self, *shape) -> "F64X":
        return F64X(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def __getitem__(self, idx) -> "F64X":
        return F64X(self.hi[idx], self.lo[idx])


def as_f64x(x) -> F64X:
    """Coerce numpy / python / F64X input into F64X (exact)."""
    if isinstance(x, F64X):
        return x
    if isinstance(x, (float, int)):
        return F64X.from_scalar(float(x))
    if isinstance(x, np.ndarray):
        return F64X.from_numpy(x)
    if isinstance(x, jax.Array):
        if x.dtype == jnp.float64:
            return from_f64(x)
        raise TypeError(f"cannot convert jax array of dtype {x.dtype} to F64X")
    raise TypeError(f"cannot convert {type(x)} to F64X")


# -- fields, usable inside jit ------------------------------------------

_EXP_MASK = np.uint32(0x7FF00000)
_MANT_HI_MASK = np.uint32(0x000FFFFF)


def exponent_field(x: F64X) -> jax.Array:
    """Biased 11-bit exponent as int32."""
    return ((x.hi & _EXP_MASK) >> np.uint32(20)).astype(jnp.int32)


def sign_bit(x: F64X) -> jax.Array:
    """1 where negative (int32)."""
    return (x.hi >> np.uint32(31)).astype(jnp.int32)


def neg(x: F64X) -> F64X:
    """Exact negation: flip the IEEE sign bit (one uint32 XOR on hi).

    Used for conjugate-transpose operands (Operation.C): conjugating a
    complex matrix carried as (re, im) F64X planes is ``neg`` on the
    imaginary plane — no value arithmetic, so it is exact for every
    input including -0.0 and non-finite values.
    """
    return F64X(x.hi ^ np.uint32(0x80000000), x.lo)


def from_f32(x: jax.Array) -> F64X:
    """Exact widening f32 -> f64 bit planes (device-side, integer ops).

    Every finite f32 (incl. subnormals) is exactly representable in f64;
    subnormal f32 inputs are renormalized using a float-conversion trick
    to find the leading bit (int -> f32 conversion is exact below 2^24,
    so its exponent field is the bit length).  Inf/NaN map to f64 Inf/NaN.
    """
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    sign = (bits >> 31) & np.int32(1)
    ef = (bits >> 23) & np.int32(0xFF)
    m = bits & np.int32(0x7FFFFF)

    # normal: exponent rebias, mantissa left-aligned from 23 to 52 bits
    e64_norm = ef - 127 + 1023
    m52_norm = m.astype(jnp.int64) << 29

    # subnormal f32: value = m * 2^-149, leading bit j via exact int->f32
    fm = m.astype(jnp.float32)
    j = (jax.lax.bitcast_convert_type(fm, jnp.int32) >> 23) - 127  # floor(log2 m)
    j = jnp.maximum(j, 0)
    e64_sub = j + 874  # (j - 149) + 1023
    m52_sub = (m.astype(jnp.int64) << (52 - j).astype(jnp.int64)) - (
        jnp.int64(1) << 52
    )

    is_zero = (ef == 0) & (m == 0)
    is_sub = (ef == 0) & (m != 0)
    is_nonfinite = ef == 255

    e64 = jnp.where(is_sub, e64_sub, e64_norm)
    e64 = jnp.where(is_nonfinite, 2047, e64)
    m52 = jnp.where(is_sub, m52_sub, m52_norm)
    bits64 = (e64.astype(jnp.int64) << 52) | m52
    bits64 = jnp.where(is_zero, jnp.int64(0), bits64)
    bits64 = bits64 | (sign.astype(jnp.int64) << 63)
    hi = (bits64 >> 32).astype(jnp.uint32)
    lo = jax.lax.convert_element_type(bits64 & np.int64(0xFFFFFFFF), jnp.uint32)
    return F64X(hi, lo)


def from_f64(x: jax.Array) -> F64X:
    """Exact bit planes of a float64 array, device-side (one bitcast).

    Works under ``jit`` and keeps every value bit-exact: subnormals,
    signed zeros, values outside float32's range, infinities and NaN
    payloads.
    """
    u = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float64), jnp.uint64)
    hi = (u >> np.uint64(32)).astype(jnp.uint32)
    lo = jax.lax.convert_element_type(u & np.uint64(0xFFFFFFFF), jnp.uint32)
    return F64X(hi, lo)


def to_f64(x: F64X) -> jax.Array:
    """The float64 array whose bits ``x`` holds (inverse of :func:`from_f64`)."""
    u = (x.hi.astype(jnp.uint64) << np.uint64(32)) | x.lo.astype(jnp.uint64)
    return jax.lax.bitcast_convert_type(u, jnp.float64)


def mantissa_parts(x: F64X) -> Tuple[jax.Array, jax.Array]:
    """(m_hi21, m_lo32): the 53-bit significand with implicit bit folded in.

    ``m_hi21`` holds bits 32..52 (21 bits incl. implicit one for normals,
    raw 20 bits for exponent-field-0 values — reference split.cu:160-162),
    ``m_lo32`` holds bits 0..31.  Both uint32.
    """
    e = exponent_field(x)
    m_hi = x.hi & _MANT_HI_MASK
    m_hi = jnp.where(e > 0, m_hi | np.uint32(1 << 20), m_hi)
    return m_hi, x.lo
