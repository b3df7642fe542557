"""The device GEMM engine: split -> int8 recombination -> exact epilogue.

Equivalent of the reference orchestration layer
(src/gemm.cu:344-521 ``gemm_int8<double/cuDoubleComplex>`` and the
dispatching ``mtk::ozimmu::gemm`` gemm.cu:524-653), with these deliberate
architecture changes:

  * no handle/arena — XLA owns memory and scheduling; the whole GEMM is a
    single fused jitted computation instead of ~100 kernel launches;
  * equal-weight slice pairs share one exact int32 total, so the
    extended-precision fold runs once per weight, not once per pair
    (ops/recombine.py);
  * all f64 carriage is exact bit planes (core/f64x.py);
  * the epilogue (alpha/beta folding, reference gemm.cu:124-239) runs in
    triple-f32 extended precision with a single final rounding.

Layout contract: row-major logical matrices.  ``gemm_f64x(a, b)`` computes
``alpha * (a @ b) + beta * c`` for a [m, k] and b [k, n].  Transpose flags
are applied by the caller/public API (core/api.py), mirroring how the
reference normalizes operands before splitting (split.cu:244-283).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..schedule import bits_per_int8
from ..core.f64x import F64X
from ..ops import tf32x3
from ..ops.pack import aligned_add, pack_f64x, scalar_triple, unpack_f64x
from ..ops.recombine import acc_shift, recombine
from ..ops.split import split_f64x, split_f64x_cols


def _epilogue_SE(S, E, alpha: float, beta: float, c: Optional[F64X]) -> F64X:
    """``alpha * (S * 2^E) + beta * c`` in extended precision, packed to
    IEEE f64 bits with one rounding (reference axby, gemm.cu:124-158)."""
    if alpha != 1.0:
        at, ae = scalar_triple(alpha)
        S = tf32x3.mul(S, at)
        E = E + np.int32(ae)
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        ct, cE = unpack_f64x(c)
        if beta != 1.0:
            bt, be = scalar_triple(beta)
            ct = tf32x3.mul(ct, bt)
            cE = cE + np.int32(be)
        S, E = aligned_add(S, E, ct, cE)
    return pack_f64x(S, E)


@partial(jax.jit, static_argnums=(2, 3, 4), inline=True)
def _gemm_core(
    a: F64X,
    b: F64X,
    num_split: int,
    alpha: float,
    beta: float,
    c: Optional[F64X] = None,
):
    """Real-valued engine core (single jitted graph)."""
    m, k = a.shape
    k2, n = b.shape
    bb = bits_per_int8(k)
    da, pa = split_f64x(a, num_split, bb)
    db, pb = split_f64x_cols(b, num_split, bb)
    S = recombine(da, db, num_split, bb, k)
    E = (pa[:, None] + pb[None, :] - acc_shift(num_split, bb)).astype(jnp.int32)
    return _epilogue_SE(S, E, alpha, beta, c)


def _col_slice(x: Optional[F64X], j0: int, j1: int) -> Optional[F64X]:
    if x is None:
        return None
    return F64X(
        jax.lax.slice_in_dim(x.hi, j0, j1, axis=1),
        jax.lax.slice_in_dim(x.lo, j0, j1, axis=1),
    )


@partial(jax.jit, static_argnums=(2, 3, 4, 5), inline=True)
def _gemm_core_nchunked(
    a: F64X,
    b: F64X,
    num_split: int,
    n_chunks: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[F64X] = None,
):
    """Column-panel-chunked engine: split A once, stream B in n panels.

    Bitwise-identical to :func:`_gemm_core` (B's split is per-column
    independent, the recombination sees the full k, and the epilogue is
    elementwise), but peak HBM for the B planes / int32 partials /
    triple-f32 accumulator drops by ~n_chunks — what lets shapes larger
    than the device memory budget run.  Full gemm contract: alpha/beta/c supported; any
    ``n`` (the last panel is simply narrower).
    """
    m, k = a.shape
    n = b.shape[1]
    if n == 0:
        return _gemm_core(a, b, num_split, alpha, beta, c)
    w = -(-n // n_chunks)
    bb = bits_per_int8(k)
    shift = np.int32(acc_shift(num_split, bb))
    da, pa = split_f64x(a, num_split, bb)
    outs = []
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        bj = _col_slice(b, j0, j1)
        db, pb = split_f64x_cols(bj, num_split, bb)
        S = recombine(da, db, num_split, bb, k)
        E = (pa[:, None] + pb[None, :] - shift).astype(jnp.int32)
        outs.append(_epilogue_SE(S, E, alpha, beta, _col_slice(c, j0, j1)))
    return F64X(
        jnp.concatenate([o.hi for o in outs], axis=1),
        jnp.concatenate([o.lo for o in outs], axis=1),
    )


def gemm_f64x(
    a: F64X,
    b: F64X,
    num_split: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[F64X] = None,
    n_chunks: Optional[int] = None,
) -> F64X:
    """Emulated FP64 GEMM on exact bit planes: alpha*(a@b) + beta*c.

    ``n_chunks=None`` auto-selects column-panel streaming from the
    working-set estimate vs the HBM budget (schedule.auto_n_chunks), so
    huge shapes work through the ordinary
    entry points with no env knobs — the reference ``gemm`` contract
    (gemm.cu:524-653) works at any size memory allows.  1 forces the
    single-graph engine; chunked and unchunked results are bitwise
    identical.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    if bits_per_int8(a.shape[1]) <= 0:
        raise ValueError(f"k={a.shape[1]} too large for int8 emulation")
    m, k = a.shape
    n = b.shape[1]
    if n_chunks is None:
        from ..schedule import auto_n_chunks

        n_chunks = auto_n_chunks(m, n, k, num_split)
    if n_chunks > 1:
        return _gemm_core_nchunked(
            a, b, num_split, n_chunks, float(alpha), float(beta), c
        )
    return _gemm_core(a, b, num_split, float(alpha), float(beta), c)


# ---------------------------------------------------------------------------
# Complex engine: 4-pass real algorithm (reference gemm.cu:412-521).
# ---------------------------------------------------------------------------


#: the reference's pass order (gemm.cu:479-518): (A-part, B-part) with
#: 0 = real plane, 1 = imag plane.
ZGEMM_PASSES = ((1, 1), (0, 0), (1, 0), (0, 1))


def _zfold_passes(SEs, m, n, alpha, beta, c_re, c_im):
    """Fold the four pass results into the complex output (shared by the
    fused `_zgemm_core` and the staged/profiled path in core.api).

    ``SEs`` lists (S, E) per entry of :data:`ZGEMM_PASSES`.  Fold factors
    (reference gemm.cu:479-518): re*re -> +alpha, im*im -> -alpha, cross
    terms -> i*alpha; C is pre-scaled by beta (init_c_complex,
    gemm.cu:199-239).
    """

    def init_part(cp):
        if beta == 0 or cp is None:
            return tf32x3.zeros((m, n)), jnp.full((m, n), -(2**20), dtype=jnp.int32)
        t, E = unpack_f64x(cp)
        return t, E

    def cmul_fold(acc, fold_re, fold_im, S, E):
        """acc(+)= (fold_re + i*fold_im) * S*2^E  on (re, im) parts."""
        (tre, Ere), (tim, Eim) = acc
        if fold_re != 0.0:
            ft, fe = scalar_triple(fold_re)
            tre, Ere = aligned_add(tre, Ere, tf32x3.mul(S, ft), E + np.int32(fe))
        if fold_im != 0.0:
            ft, fe = scalar_triple(fold_im)
            tim, Eim = aligned_add(tim, Eim, tf32x3.mul(S, ft), E + np.int32(fe))
        return (tre, Ere), (tim, Eim)

    acc_re = init_part(c_re)
    acc_im = init_part(c_im)
    if beta != 0 and beta != 1:
        # (re + i*im) * beta
        br, bi = beta.real, beta.imag
        tre, Ere = acc_re
        tim, Eim = acc_im
        new_re = tf32x3.zeros((m, n)), jnp.full((m, n), -(2**20), dtype=jnp.int32)
        new_im = tf32x3.zeros((m, n)), jnp.full((m, n), -(2**20), dtype=jnp.int32)
        acc = (new_re, new_im)
        acc = cmul_fold(acc, br, bi, tre, Ere)
        acc = cmul_fold(acc, -bi, br, tim, Eim)
        acc_re, acc_im = acc

    for (ap, bp), (S, E) in zip(ZGEMM_PASSES, SEs):
        if ap == 0 and bp == 0:
            fold = alpha
        elif ap == 1 and bp == 1:
            fold = -alpha
        else:
            fold = complex(-alpha.imag, alpha.real)
        acc_re, acc_im = cmul_fold((acc_re, acc_im), fold.real, fold.imag, S, E)

    out_re = pack_f64x(acc_re[0], acc_re[1])
    out_im = pack_f64x(acc_im[0], acc_im[1])
    return out_re, out_im


@partial(jax.jit, static_argnums=(4, 5, 6), inline=True)
def _zgemm_core(
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    num_split: int,
    alpha: complex,
    beta: complex,
    c_re: Optional[F64X] = None,
    c_im: Optional[F64X] = None,
):
    m, k = a_re.shape
    n = b_re.shape[1]
    bb = bits_per_int8(k)
    shift = np.int32(acc_shift(num_split, bb))

    da_re, pa_re = split_f64x(a_re, num_split, bb)
    da_im, pa_im = split_f64x(a_im, num_split, bb)
    db_re, pb_re = split_f64x_cols(b_re, num_split, bb)
    db_im, pb_im = split_f64x_cols(b_im, num_split, bb)

    a_planes = {0: (da_re, pa_re), 1: (da_im, pa_im)}
    b_planes = {0: (db_re, pb_re), 1: (db_im, pb_im)}

    SEs = []
    for ap, bp in ZGEMM_PASSES:
        da, pa = a_planes[ap]
        db, pb = b_planes[bp]
        S = recombine(da, db, num_split, bb, k)
        E = (pa[:, None] + pb[None, :] - shift).astype(jnp.int32)
        SEs.append((S, E))
    return _zfold_passes(SEs, m, n, alpha, beta, c_re, c_im)


@partial(jax.jit, static_argnums=(4, 5, 6, 7), inline=True)
def _zgemm_core_nchunked(
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    num_split: int,
    n_chunks: int,
    alpha: complex,
    beta: complex,
    c_re: Optional[F64X] = None,
    c_im: Optional[F64X] = None,
):
    """Column-panel-chunked 4-pass complex engine (bitwise-identical to
    :func:`_zgemm_core`): A's four plane splits happen once; each B
    column panel runs the four recombination passes and the complex fold
    locally (the fold is elementwise, so chunking columns is exact)."""
    m, k = a_re.shape
    n = b_re.shape[1]
    if n == 0:
        return _zgemm_core(
            a_re, a_im, b_re, b_im, num_split, alpha, beta, c_re, c_im
        )
    w = -(-n // n_chunks)
    bb = bits_per_int8(k)
    shift = np.int32(acc_shift(num_split, bb))

    da_re, pa_re = split_f64x(a_re, num_split, bb)
    da_im, pa_im = split_f64x(a_im, num_split, bb)
    a_planes = {0: (da_re, pa_re), 1: (da_im, pa_im)}

    outs_re, outs_im = [], []
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        db_re, pb_re = split_f64x_cols(_col_slice(b_re, j0, j1), num_split, bb)
        db_im, pb_im = split_f64x_cols(_col_slice(b_im, j0, j1), num_split, bb)
        b_planes = {0: (db_re, pb_re), 1: (db_im, pb_im)}
        SEs = []
        for ap, bp in ZGEMM_PASSES:
            da, pa = a_planes[ap]
            db, pb = b_planes[bp]
            S = recombine(da, db, num_split, bb, k)
            E = (pa[:, None] + pb[None, :] - shift).astype(jnp.int32)
            SEs.append((S, E))
        o_re, o_im = _zfold_passes(
            SEs, m, j1 - j0, alpha, beta,
            _col_slice(c_re, j0, j1), _col_slice(c_im, j0, j1),
        )
        outs_re.append(o_re)
        outs_im.append(o_im)

    def cat(outs):
        return F64X(
            jnp.concatenate([o.hi for o in outs], axis=1),
            jnp.concatenate([o.lo for o in outs], axis=1),
        )

    return cat(outs_re), cat(outs_im)


def zgemm_f64x(
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    num_split: int,
    alpha: complex = 1.0 + 0j,
    beta: complex = 0.0 + 0j,
    c_re: Optional[F64X] = None,
    c_im: Optional[F64X] = None,
    n_chunks: Optional[int] = None,
):
    """Emulated complex FP64 GEMM (4-pass real engine).

    Like :func:`gemm_f64x`, ``n_chunks=None`` auto-selects column-panel
    streaming from the working-set estimate so huge complex shapes run
    through the ordinary entry point; chunked output is bitwise-identical.
    """
    m, k = a_re.shape
    n = b_re.shape[1]
    if n_chunks is None:
        from ..schedule import auto_n_chunks

        n_chunks = auto_n_chunks(m, n, k, num_split, complex_=True)
    if n_chunks > 1:
        return _zgemm_core_nchunked(
            a_re, a_im, b_re, b_im, num_split, n_chunks,
            complex(alpha), complex(beta), c_re, c_im,
        )
    return _zgemm_core(
        a_re, a_im, b_re, b_im, num_split, complex(alpha), complex(beta), c_re, c_im
    )
