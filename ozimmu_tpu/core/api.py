"""Public GEMM API: mode dispatch, operand normalization, profiling.

Equivalent of ``mtk::ozimmu::gemm`` (reference src/gemm.cu:524-653):
argument validation, per-mode dispatch (int8 engine / auto selection /
native fallback / f32 demotion), plus the profiling hooks the reference
wires through its handle.

Input/output convention: row-major logical matrices, numpy float64 or
complex128 (exact, host-side bits), or :class:`F64X` bit planes already on
device.  ``op_a``/``op_b`` apply BLAS-style transposes to the *logical*
matrices: ``gemm(a, b, op_a="T")`` computes ``alpha * a.T @ b + beta*c``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import tf32x3
from ..ops.mantissa_loss import auto_mode_select as _auto_mode_select_core
from ..ops.pack import aligned_add, pack_f64x, scalar_triple, unpack_f64x
from ..ops.recombine import acc_shift, recombine
from ..ops.split import split_f64x, split_f64x_cols
from ..schedule import bits_per_int8
from ..types import ComputeMode, ComputeModeLike, ElementKind, Operation, OperationLike
from ..utils.log import log
from ..utils.profiling import culip_timer
from .f64x import F64X, as_f64x, from_f32, from_f64, to_f64
from .gemm import gemm_f64x, zgemm_f64x
from .handle import Handle, default_handle

ArrayLike = Union[np.ndarray, F64X]


def _apply_op_np(x: np.ndarray, op: Operation) -> np.ndarray:
    if op is Operation.N:
        return x
    if op is Operation.C and np.iscomplexobj(x):
        return np.conj(x).T
    return x.T  # T, or C on real input (conjugation is the identity)


def _apply_op_f64x(x: F64X, op: Operation) -> F64X:
    # F64X carries real planes; C == T (conjugation is the identity)
    return x if op is Operation.N else x.transpose()


def _require_x64() -> None:
    """The engine carries int64 in the pack kernel; JAX must run with x64
    enabled or the compiler silently truncates to int32 and corrupts
    results."""
    import jax as _jax

    if not _jax.config.jax_enable_x64:
        raise RuntimeError(
            "ozimmu_tpu requires jax_enable_x64: call "
            'jax.config.update("jax_enable_x64", True) before using the engine'
        )


def _check_k_supported(k: int) -> None:
    if bits_per_int8(k) <= 0:
        raise ValueError(
            f"k={k} exceeds the int8 emulation bound (needs k*2^(2b) <= 2^31);"
            " shard or chunk the contraction"
        )


# ---------------------------------------------------------------------------
# native (dgemm) and demoted (sgemm) fallbacks
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3))
def _native_gemm(a, b, alpha, beta, c=None):
    """``alpha * a @ b + beta * c`` in the operands' own dtype on device
    (float64 -> cuBLAS DGEMM, complex128 -> ZGEMM on the GPU); batched
    [B, m, k] operands are fine too."""
    r = jnp.matmul(a, b, preferred_element_type=a.dtype)
    if alpha != 1:
        r = alpha * r
    if beta != 0:
        r = r + beta * c
    return r


@partial(jax.jit, inline=True)
def _f64x_to_f32(x: F64X) -> jax.Array:
    """Round-to-nearest-ish f32 view of exact f64 bits (device-side)."""
    t, E = unpack_f64x(x)
    scaled = tf32x3.scale_pow2(t, E)
    return scaled[0] + scaled[1] + scaled[2]


@partial(jax.jit, inline=True)
def _sgemm_core(a: F64X, b: F64X) -> F64X:
    """f32-demoted GEMM (reference cublas_helper.cu:83-216 semantics):
    demote operands to f32, matmul in f32, widen the result exactly."""
    a32 = _f64x_to_f32(a)
    b32 = _f64x_to_f32(b)
    # HIGHEST: true f32 products — the GPU's default f32 matmul may run
    # in TF32, which would defeat the point of the demotion mode.
    c32 = jnp.dot(
        a32, b32, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
    )
    return from_f32(c32)


@partial(jax.jit, inline=True, static_argnums=(4, 5))
def _csgemm_core(
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    alpha: complex,
    beta: complex,
    c_re: Optional[F64X] = None,
    c_im: Optional[F64X] = None,
):
    """Complex f32-demoted GEMM on device (reference Cgemm demotion,
    cublas_helper.cu:123-125,190-216): demote the re/im planes to f32,
    run 4 real f32 HIGHEST matmuls, apply alpha/beta in f32 (the
    reference passes cuComplex scalars to cublasCgemm), widen exactly."""
    a32r, a32i = _f64x_to_f32(a_re), _f64x_to_f32(a_im)
    b32r, b32i = _f64x_to_f32(b_re), _f64x_to_f32(b_im)

    def dot(x, y):
        return jnp.dot(
            x, y, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
        )

    p_re = dot(a32r, b32r) - dot(a32i, b32i)
    p_im = dot(a32r, b32i) + dot(a32i, b32r)
    al_r, al_i = np.float32(alpha.real), np.float32(alpha.imag)
    o_re = al_r * p_re - al_i * p_im
    o_im = al_r * p_im + al_i * p_re
    if beta != 0 and c_re is not None:
        c32r, c32i = _f64x_to_f32(c_re), _f64x_to_f32(c_im)
        be_r, be_i = np.float32(beta.real), np.float32(beta.imag)
        o_re = o_re + be_r * c32r - be_i * c32i
        o_im = o_im + be_r * c32i + be_i * c32r
    return from_f32(o_re), from_f32(o_im)


# ---------------------------------------------------------------------------
# staged (profiled) int8 path — same math as core.gemm._gemm_core but as
# separate dispatches so phases can be timed (reference labels
# gemm.cu:38-48,312,393,404).
# ---------------------------------------------------------------------------

_split_rows = jax.jit(split_f64x, static_argnums=(1, 2))
_split_cols = jax.jit(split_f64x_cols, static_argnums=(1, 2))
_recombine_j = jax.jit(recombine, static_argnums=(2, 3, 4))


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _epilogue(S, pa, pb, num_split, b, alpha, beta, c=None):
    E = (pa[:, None] + pb[None, :] - acc_shift(num_split, b)).astype(jnp.int32)
    if alpha != 1.0:
        at, ae = scalar_triple(alpha)
        S = tf32x3.mul(S, at)
        E = E + np.int32(ae)
    if beta != 0.0:
        ct, cE = unpack_f64x(c)
        if beta != 1.0:
            bt, be = scalar_triple(beta)
            ct = tf32x3.mul(ct, bt)
            cE = cE + np.int32(be)
        S, E = aligned_add(S, E, ct, cE)
    return pack_f64x(S, E)


def _zfold_jit(SEs, alpha, beta, c_re, c_im):
    from .gemm import _zfold_passes

    m, n = SEs[0][1].shape
    return _zfold_passes(SEs, m, n, alpha, beta, c_re, c_im)


_zfold_j = jax.jit(_zfold_jit, static_argnums=(1, 2))


def _zgemm_staged(
    handle: Handle,
    a_re: F64X,
    a_im: F64X,
    b_re: F64X,
    b_im: F64X,
    num_split: int,
    alpha: complex,
    beta: complex,
    c_re: Optional[F64X],
    c_im: Optional[F64X],
):
    """Phase-profiled 4-pass complex engine (reference profiles the
    complex engine with the same labels as the real one, gemm.cu:412-521)."""
    from .gemm import ZGEMM_PASSES

    prof = handle.profiler
    k = a_re.shape[1]
    bb = bits_per_int8(k)
    shift = np.int32(acc_shift(num_split, bb))
    with prof.phase("split_A"):
        da_re, pa_re = _split_rows(a_re, num_split, bb)
        da_im, pa_im = _split_rows(a_im, num_split, bb)
        jax.block_until_ready(da_re)
    with prof.phase("split_B"):
        db_re, pb_re = _split_cols(b_re, num_split, bb)
        db_im, pb_im = _split_cols(b_im, num_split, bb)
        jax.block_until_ready(db_re)
    a_planes = {0: (da_re, pa_re), 1: (da_im, pa_im)}
    b_planes = {0: (db_re, pb_re), 1: (db_im, pb_im)}
    SEs = []
    with prof.phase("int8tc+accumulate_in_f64"):
        for ap, bp in ZGEMM_PASSES:
            da, pa = a_planes[ap]
            db, pb = b_planes[bp]
            S = _recombine_j(da, db, num_split, bb, k)
            E = (pa[:, None] + pb[None, :] - shift).astype(jnp.int32)
            SEs.append((S, E))
        jax.block_until_ready(SEs[-1][0])
    with prof.phase("copy_result"):
        out_re, out_im = _zfold_j(SEs, complex(alpha), complex(beta), c_re, c_im)
        jax.block_until_ready(out_re.hi)
    return out_re, out_im


def _gemm_staged(
    handle: Handle,
    a: F64X,
    b: F64X,
    num_split: int,
    alpha: float,
    beta: float,
    c: Optional[F64X],
) -> F64X:
    prof = handle.profiler
    k = a.shape[1]
    bb = bits_per_int8(k)
    with prof.phase("split_A"):
        da, pa = _split_rows(a, num_split, bb)
        jax.block_until_ready(da)
    with prof.phase("split_B"):
        db, pb = _split_cols(b, num_split, bb)
        jax.block_until_ready(db)
    with prof.phase("int8tc+accumulate_in_f64"):
        S = _recombine_j(da, db, num_split, bb, k)
        jax.block_until_ready(S)
    with prof.phase("copy_result"):
        out = _epilogue(S, pa, pb, num_split, bb, float(alpha), float(beta), c)
        jax.block_until_ready(out.hi)
    return out


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def gemm(
    a: ArrayLike,
    b: ArrayLike,
    *,
    mode: Optional[ComputeModeLike] = None,
    op_a: OperationLike = Operation.N,
    op_b: OperationLike = Operation.N,
    alpha=1.0,
    beta=0.0,
    c: Optional[ArrayLike] = None,
    handle: Optional[Handle] = None,
):
    """``alpha * op(a) @ op(b) + beta * c`` with the selected compute mode.

    Returns the same container kind as ``a`` (numpy -> numpy, F64X -> F64X).
    Complex (numpy complex128) inputs run the 4-pass complex engine.

    ``op_a``/``op_b`` accept ``"N"``, ``"T"`` and ``"C"`` (conjugate
    transpose) — the reference silently degrades ``CUBLAS_OP_C`` to
    ``op_t`` (src/cublas.cu:50-56), here it is exact; on real operands
    C and T coincide.

    NaN/Inf contract (same as the reference, whose split kernel reads
    exponent bits without a non-finite check, split.cu:154-185): a NaN or
    +-Inf element makes its OWN output row (via A) or column (via B)
    garbage — the 0x7FF exponent field enters that row/column's max-
    exponent scale, so affected outputs come back huge-finite or +-Inf,
    NOT necessarily NaN.  Rows/columns without non-finite elements are
    computed exactly as usual.  Set ``OZIMMU_CHECK_FINITE=1`` to raise
    ``ValueError`` on non-finite numpy inputs instead (tested in
    tests/test_api.py::TestNonFiniteContract).
    """
    _require_x64()
    handle = handle or default_handle()

    if isinstance(a, np.ndarray):
        from ..utils.env import env_flag

        if env_flag("OZIMMU_CHECK_FINITE", False):
            for nm, arr in (("a", a), ("b", b), ("c", c)):
                if arr is not None and not np.isfinite(arr).all():
                    raise ValueError(
                        f"non-finite values in operand {nm} "
                        "(OZIMMU_CHECK_FINITE=1; NaN/Inf are outside the "
                        "engine contract)"
                    )
    mode_r = handle.resolve_mode(mode)
    op_a = Operation.parse(op_a)
    op_b = Operation.parse(op_b)

    is_np = isinstance(a, np.ndarray)
    complex_in = is_np and np.iscomplexobj(a)
    if complex_in:
        return _gemm_complex_np(handle, a, b, mode_r, op_a, op_b, alpha, beta, c)

    # normalize to F64X [m, k] / [k, n]
    if is_np:
        ax = F64X.from_numpy(np.ascontiguousarray(_apply_op_np(a, op_a), dtype=np.float64))
        bx = F64X.from_numpy(np.ascontiguousarray(_apply_op_np(b, op_b), dtype=np.float64))
        cx = F64X.from_numpy(np.ascontiguousarray(c, dtype=np.float64)) if c is not None else None
    else:
        ax = _apply_op_f64x(as_f64x(a), op_a)
        bx = _apply_op_f64x(as_f64x(b), op_b)
        cx = as_f64x(c) if c is not None else None

    m, k = ax.shape
    k2, n = bx.shape
    if k != k2:
        raise ValueError(f"shape mismatch: op(a)={ax.shape} @ op(b)={bx.shape}")
    if cx is not None and cx.shape != (m, n):
        raise ValueError(f"c has shape {cx.shape}, expected {(m, n)}")

    if mode_r is ComputeMode.FP64_INT8_AUTO:
        mode_r = _auto_mode_select_core(ax, bx, k, handle.avg_mantissa_loss_threshold)
        log(
            f"AUTO selected mode = {mode_r.value}, threshold average mantissa "
            f"loss = {handle.avg_mantissa_loss_threshold}"
        )

    name = f"ozimmu_gemm-{mode_r.value}-m{m}-n{n}-k{k}"
    with culip_timer(name):
        if mode_r.is_int8:
            _check_k_supported(k)
            if handle.profiler.enabled:
                out = _gemm_staged(handle, ax, bx, mode_r.num_split, alpha, beta, cx)
            else:
                out = gemm_f64x(ax, bx, mode_r.num_split, alpha=alpha, beta=beta, c=cx)
        elif mode_r is ComputeMode.SGEMM:
            out = _sgemm_core(ax, bx)
            if alpha != 1.0 or beta != 0.0:
                # fold alpha/beta exactly on the widened result
                t, E = unpack_f64x(out)
                out = _epilogue_scalar(t, E, float(alpha), float(beta), cx)
        elif mode_r is ComputeMode.DGEMM:
            # native IEEE f64 on device (cuBLAS DGEMM on the GPU)
            if beta != 0.0 and cx is None:
                raise ValueError("beta != 0 requires c")
            out = from_f64(
                _native_gemm(
                    to_f64(ax), to_f64(bx), float(alpha), float(beta),
                    to_f64(cx) if beta != 0.0 else None,
                )
            )
        else:
            raise NotImplementedError(f"mode {mode_r} not implemented")
        jax.block_until_ready(out.hi)

    return out.to_numpy().reshape(m, n) if is_np else out


@partial(jax.jit, static_argnums=(2, 3))
def _epilogue_scalar(t, E, alpha, beta, c=None):
    if alpha != 1.0:
        at, ae = scalar_triple(alpha)
        t = tf32x3.mul(t, at)
        E = E + np.int32(ae)
    if beta != 0.0 and c is not None:
        ct, cE = unpack_f64x(c)
        if beta != 1.0:
            bt, be = scalar_triple(beta)
            ct = tf32x3.mul(ct, bt)
            cE = cE + np.int32(be)
        t, E = aligned_add(t, E, ct, cE)
    return pack_f64x(t, E)


def _gemm_complex_np(handle, a, b, mode_r, op_a, op_b, alpha, beta, c):
    a = _apply_op_np(np.asarray(a, dtype=np.complex128), op_a)
    b = _apply_op_np(np.asarray(b, dtype=np.complex128), op_b)
    m, k = a.shape
    _, n = b.shape
    axr = axi = bxr = bxi = None

    def planes():
        # built lazily: only the AUTO and int8 branches need the F64X
        # bit planes — the dgemm/sgemm escapes must not pay 4 full-
        # matrix conversions they never use
        nonlocal axr, axi, bxr, bxi
        if axr is None:
            axr = F64X.from_numpy(np.ascontiguousarray(a.real))
            axi = F64X.from_numpy(np.ascontiguousarray(a.imag))
            bxr = F64X.from_numpy(np.ascontiguousarray(b.real))
            bxi = F64X.from_numpy(np.ascontiguousarray(b.imag))
        return axr, axi, bxr, bxi

    if mode_r is ComputeMode.FP64_INT8_AUTO:
        # ONE shared loss counter over all four re/im planes (reference
        # complex estimator split.cu:69-152 + selection 473-493) — the
        # same auto_mode_select_complex every other surface uses
        from ..ops.mantissa_loss import auto_mode_select_complex

        mode_r = auto_mode_select_complex(
            *planes(), k, handle.avg_mantissa_loss_threshold
        )
        log(f"AUTO selected mode = {mode_r.value} (complex)")

    if beta != 0 and c is None:
        raise ValueError("beta != 0 requires c")
    name = f"ozimmu_zgemm-{mode_r.value}-m{m}-n{n}-k{k}"
    with culip_timer(name):
        if mode_r.is_int8:
            _check_k_supported(k)
            axr, axi, bxr, bxi = planes()
            cre = F64X.from_numpy(np.ascontiguousarray(c.real)) if c is not None else None
            cim = F64X.from_numpy(np.ascontiguousarray(c.imag)) if c is not None else None
            if handle.profiler.enabled:
                re, im = _zgemm_staged(
                    handle, axr, axi, bxr, bxi, mode_r.num_split,
                    complex(alpha), complex(beta), cre, cim,
                )
            else:
                re, im = zgemm_f64x(
                    axr, axi, bxr, bxi, mode_r.num_split,
                    alpha=complex(alpha), beta=complex(beta), c_re=cre, c_im=cim,
                )
            jax.block_until_ready(re.hi)
            out = re.to_numpy().reshape(m, n) + 1j * im.to_numpy().reshape(m, n)
        elif mode_r is ComputeMode.DGEMM:
            # native complex128 product on device (cuBLAS ZGEMM on the GPU)
            out = np.asarray(
                _native_gemm(
                    jnp.asarray(a), jnp.asarray(b), complex(alpha), complex(beta),
                    jnp.asarray(c, dtype=jnp.complex128) if beta != 0 else None,
                )
            )
        elif mode_r is ComputeMode.SGEMM:
            # device-side demotion (reference cublas_helper.cu:123-125):
            # f32 re/im planes, 4 real f32 HIGHEST matmuls, exact widen
            re, im = _csgemm_core(
                *planes(),
                complex(alpha),
                complex(beta),
                F64X.from_numpy(np.ascontiguousarray(c.real)) if c is not None else None,
                F64X.from_numpy(np.ascontiguousarray(c.imag)) if c is not None else None,
            )
            jax.block_until_ready(re.hi)
            out = re.to_numpy().reshape(m, n) + 1j * im.to_numpy().reshape(m, n)
        else:
            raise NotImplementedError(f"mode {mode_r} not implemented (complex)")
    return out


def matmul(a: ArrayLike, b: ArrayLike, *, mode: Optional[ComputeModeLike] = None, handle=None):
    """NumPy-style ``a @ b`` through the engine."""
    return gemm(a, b, mode=mode, handle=handle)


def gemm_batched(
    a: np.ndarray,
    b: np.ndarray,
    *,
    mode: Optional[ComputeModeLike] = None,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[np.ndarray] = None,
    handle: Optional[Handle] = None,
) -> np.ndarray:
    """Batched GEMM [B, m, k] @ [B, k, n] (strided-batched parity,
    reference cublas.cu:380-406 — which loops; here a single vmapped jit).
    Real (Dgemm) and complex (Zgemm) batches both supported."""
    handle = handle or default_handle()
    mode_r = handle.resolve_mode(mode)
    if np.iscomplexobj(a) or np.iscomplexobj(b):
        return _gemm_batched_complex(a, b, mode_r, alpha, beta, c, handle)
    if mode_r is ComputeMode.FP64_INT8_AUTO:
        # select on the flattened batch (one mode for the whole batch)
        k = a.shape[2]
        ax = F64X.from_numpy(np.ascontiguousarray(a.reshape(-1, k)))
        bx = F64X.from_numpy(np.ascontiguousarray(np.swapaxes(b, 1, 2).reshape(-1, k)))
        mode_r = _auto_mode_select_core(ax, bx, k, handle.avg_mantissa_loss_threshold, b_is_cols=False)
        log(f"AUTO selected mode = {mode_r.value} (batched)")
    if mode_r is ComputeMode.SGEMM:
        # f32-demoted batch (reference dgemm_f32_batched,
        # cublas_helper.cu:20-67 semantics): demote, batched f32 matmul,
        # widen exactly; same epilogue as the 2D path.
        fn = jax.vmap(_sgemm_core)
        r = fn(F64X.from_numpy(a), F64X.from_numpy(b))
        out = r.to_numpy().reshape(a.shape[0], a.shape[1], b.shape[2]) * alpha
        if beta != 0 and c is not None:
            out = out + beta * c
        return out
    if not mode_r.is_int8:
        return np.asarray(
            _native_gemm(
                jnp.asarray(a, jnp.float64), jnp.asarray(b, jnp.float64),
                float(alpha), float(beta) if c is not None else 0.0,
                jnp.asarray(c, jnp.float64) if c is not None else None,
            )
        )
    _check_k_supported(a.shape[2])
    ns = mode_r.num_split

    from .gemm import _gemm_core

    if c is None:
        fn = jax.vmap(lambda x, y: _gemm_core(x, y, ns, float(alpha), 0.0))
        r = fn(F64X.from_numpy(a), F64X.from_numpy(b))
        return r.to_numpy().reshape(a.shape[0], a.shape[1], b.shape[2])
    fn = jax.vmap(lambda x, y, z: _gemm_core(x, y, ns, float(alpha), float(beta), z))
    r = fn(F64X.from_numpy(a), F64X.from_numpy(b), F64X.from_numpy(c))
    return r.to_numpy().reshape(a.shape[0], a.shape[1], b.shape[2])


def _gemm_batched_complex(a, b, mode_r, alpha, beta, c, handle):
    """Vmapped ZGEMM batch (reference ZgemmStridedBatched shim parity)."""
    from .gemm import _zgemm_core

    a = np.ascontiguousarray(a, dtype=np.complex128)
    b = np.ascontiguousarray(b, dtype=np.complex128)
    B, m, k = a.shape
    n = b.shape[2]
    if mode_r is ComputeMode.FP64_INT8_AUTO:
        # one mode for the whole batch: the SAME shared four-plane counter
        # as every other complex surface, over the flattened batch (rows
        # of [B*m, k] / [B*n, k] are exactly the per-matrix scale groups)
        from ..ops.mantissa_loss import auto_mode_select_complex

        mode_r = auto_mode_select_complex(
            F64X.from_numpy(a.real.reshape(-1, k)),
            F64X.from_numpy(a.imag.reshape(-1, k)),
            F64X.from_numpy(np.ascontiguousarray(np.swapaxes(b.real, 1, 2)).reshape(-1, k)),
            F64X.from_numpy(np.ascontiguousarray(np.swapaxes(b.imag, 1, 2)).reshape(-1, k)),
            k,
            handle.avg_mantissa_loss_threshold,
            b_is_cols=False,
        )
        log(f"AUTO selected mode = {mode_r.value} (batched complex)")
    if mode_r is ComputeMode.SGEMM:
        # f32-demoted complex batch (reference CgemmStridedBatched demotion,
        # cublas_helper.cu:190-216): vmapped device demote/widen — NOT the
        # full-precision einsum below.
        al, be = complex(alpha), complex(beta)
        if c is None or be == 0:
            fn = jax.vmap(lambda ar, ai, br, bi: _csgemm_core(ar, ai, br, bi, al, 0j))
            re, im = fn(
                F64X.from_numpy(a.real), F64X.from_numpy(a.imag),
                F64X.from_numpy(b.real), F64X.from_numpy(b.imag),
            )
        else:
            c = np.ascontiguousarray(c, dtype=np.complex128)
            fn = jax.vmap(
                lambda ar, ai, br, bi, cr, ci: _csgemm_core(ar, ai, br, bi, al, be, cr, ci)
            )
            re, im = fn(
                F64X.from_numpy(a.real), F64X.from_numpy(a.imag),
                F64X.from_numpy(b.real), F64X.from_numpy(b.imag),
                F64X.from_numpy(c.real), F64X.from_numpy(c.imag),
            )
        return re.to_numpy().reshape(B, m, n) + 1j * im.to_numpy().reshape(B, m, n)
    if not mode_r.is_int8:
        with_c = c is not None and complex(beta) != 0
        return np.asarray(
            _native_gemm(
                jnp.asarray(a), jnp.asarray(b), complex(alpha),
                complex(beta) if with_c else 0j,
                jnp.asarray(c, jnp.complex128) if with_c else None,
            )
        )
    _check_k_supported(k)
    ns = mode_r.num_split
    al, be = complex(alpha), complex(beta)

    if c is None:
        fn = jax.vmap(lambda ar, ai, br, bi: _zgemm_core(ar, ai, br, bi, ns, al, 0j))
        re, im = fn(
            F64X.from_numpy(a.real), F64X.from_numpy(a.imag),
            F64X.from_numpy(b.real), F64X.from_numpy(b.imag),
        )
    else:
        c = np.ascontiguousarray(c, dtype=np.complex128)
        fn = jax.vmap(
            lambda ar, ai, br, bi, cr, ci: _zgemm_core(
                ar, ai, br, bi, ns, al, be, cr, ci
            )
        )
        re, im = fn(
            F64X.from_numpy(a.real), F64X.from_numpy(a.imag),
            F64X.from_numpy(b.real), F64X.from_numpy(b.imag),
            F64X.from_numpy(c.real), F64X.from_numpy(c.imag),
        )
    return (
        re.to_numpy().reshape(B, m, n) + 1j * im.to_numpy().reshape(B, m, n)
    )


def auto_mode_select(
    a: np.ndarray,
    b: np.ndarray,
    *,
    op_a: OperationLike = Operation.N,
    op_b: OperationLike = Operation.N,
    threshold: Optional[float] = None,
    handle: Optional[Handle] = None,
) -> ComputeMode:
    """Standalone auto-mode query (reference ozimmu.hpp:84-92)."""
    handle = handle or default_handle()
    if threshold is None:
        threshold = handle.avg_mantissa_loss_threshold
    an = np.ascontiguousarray(_apply_op_np(np.asarray(a, dtype=np.float64), Operation.parse(op_a)))
    bn = np.ascontiguousarray(_apply_op_np(np.asarray(b, dtype=np.float64), Operation.parse(op_b)))
    return _auto_mode_select_core(
        F64X.from_numpy(an), F64X.from_numpy(bn), an.shape[1], threshold
    )


def warmup(
    m: int,
    n: int,
    k: int,
    mode: ComputeModeLike,
    kind: ElementKind = ElementKind.REAL,
    handle: Optional[Handle] = None,
) -> None:
    """Ahead-of-time compile the engine for one GEMM shape."""
    mode = ComputeMode.parse(mode)
    if kind == ElementKind.COMPLEX:
        a = np.zeros((m, k), dtype=np.complex128)
        b = np.zeros((k, n), dtype=np.complex128)
    else:
        a = np.zeros((m, k), dtype=np.float64)
        b = np.zeros((k, n), dtype=np.float64)
    gemm(a, b, mode=mode, handle=handle)
