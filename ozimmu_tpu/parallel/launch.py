"""Multi-process (multi-host) launch utilities.

The reference is strictly single-GPU, single-process (SURVEY.md §2: no
NCCL/MPI); the north star (BASELINE.md configs[4]) requires running the
SAME sharded GEMMs across processes.  The pieces:

  * :func:`initialize` — ``jax.distributed.initialize`` with env
    fallbacks, so a launcher only has to export three variables;
  * :func:`make_mesh_2d_hybrid` — a 2D (x, y) mesh over every process's
    devices in which each process's local devices form one contiguous
    block, and the process dimension is the OUTER factor of one axis.
    Only that axis's collectives cross a process boundary (the slower
    network between hosts); everything else stays on the host's own
    interconnect;
  * :func:`replicated_f64x` — build a sharded global F64X from an
    identical per-process numpy array (the multi-process analogue of
    ``device_put``).

The engine's cross-device reductions are exact int32 sums and the
epilogue is elementwise, so multi-process results are BITWISE-identical
to single-process and single-device execution — asserted by
tests/test_multiprocess.py on 2 processes x 4 virtual CPU devices.

Problem shape -> variant selection (see parallel/gemm.py for the
variants, and ``select_variant`` for the code):

  ============================  =====================================
  regime                        variant
  ============================  =====================================
  operands fit every device     ``sharded_gemm_fn`` (all-gather SUMMA;
                                fewest collective steps, XLA overlaps
                                the two independent gathers)
  huge operands, square mesh    ``sharded_gemm_ring_fn`` /
                                ``sharded_zgemm_ring_fn`` (Cannon:
                                2-panel peak memory, neighbour-only
                                ppermute traffic)
  tall contraction (huge k,     ``sharded_gemm_k_fn`` (1D k-sharded;
  modest m*n)                   psum_scatter of int32 group totals)
  several processes             same variants on a hybrid mesh; put
                                the process cut on the axis with the
                                SMALLER gather volume (x gathers B's
                                ns*k*(n/y) bytes, y gathers A's
                                ns*(m/x)*k — pick via
                                :func:`process_axis_for`)
  ============================  =====================================
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding

from ..core.f64x import F64X


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` with OZIMMU_* env fallbacks.

    Env: ``OZIMMU_COORDINATOR`` (host:port), ``OZIMMU_NUM_PROCS``,
    ``OZIMMU_PROC_ID``.  All three are required unless a cluster
    environment JAX recognises supplies them.  Call BEFORE any other JAX
    API (backend queries freeze the topology).
    """
    kwargs = {}
    coord = coordinator_address or os.environ.get("OZIMMU_COORDINATOR")
    if coord is not None:
        kwargs["coordinator_address"] = coord
    nproc = num_processes or os.environ.get("OZIMMU_NUM_PROCS")
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    pid = process_id if process_id is not None else os.environ.get("OZIMMU_PROC_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def process_axis_for(
    m: int, n: int, k: int, num_split: int,
    axis_x: str = "x", axis_y: str = "y",
) -> str:
    """Which 2D-mesh axis should absorb the process (host) cut.

    The SUMMA variant all-gathers A's planes along y (ns*(m/x)*k int8
    bytes per device) and B's planes along x (ns*k*(n/y) bytes).  The
    slower network belongs on the axis that moves FEWER bytes: gathering
    along x crosses the x-cut, so put the process cut on x when B's
    gather is the smaller, else on y.
    """
    # per-device gather bytes are proportional to m (y-gather) vs n
    # (x-gather) once the mesh is square-ish; ns and k cancel.  Returns
    # the CALLER'S axis names so custom-named meshes can't silently get
    # the cut on the wrong axis.
    return axis_x if n <= m else axis_y


def make_mesh_2d_hybrid(
    axis_x: str = "x",
    axis_y: str = "y",
    process_axis: Optional[str] = None,
) -> Mesh:
    """2D (x, y) mesh over ALL processes' devices, one block per process.

    Each process's local devices form a contiguous (xi, yi) block (xi as
    square as possible); the process dimension multiplies into
    ``process_axis`` (default x) as its OUTER factor.  Single-process
    falls back to :func:`make_mesh_2d` unchanged.
    """
    from .gemm import make_mesh_2d

    nproc = jax.process_count()
    if nproc <= 1:
        return make_mesh_2d(axis_x=axis_x, axis_y=axis_y)
    process_axis = process_axis or axis_x
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    local = len(devs) // nproc
    xi = int(np.floor(np.sqrt(local)))
    while local % xi:
        xi -= 1
    yi = local // xi
    blocks = np.array(devs, dtype=object).reshape(nproc, xi, yi)
    if process_axis == axis_x:
        arr = blocks.reshape(nproc * xi, yi)
    else:
        arr = blocks.transpose(1, 0, 2).reshape(xi, nproc * yi)
    return Mesh(arr, (axis_x, axis_y))


def replicated_f64x(
    x: np.ndarray, mesh: Mesh, spec
) -> F64X:
    """Shard an identical-on-every-process numpy f64 array onto the mesh.

    Multi-process safe: uses ``jax.make_array_from_callback`` so each
    process materializes only its addressable shards.  ``spec`` is a
    ``PartitionSpec``.
    """
    bits = np.ascontiguousarray(x, np.float64).view(np.uint64)
    hi_np = (bits >> np.uint64(32)).astype(np.uint32)
    lo_np = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sharding = NamedSharding(mesh, spec)

    def mk(arr):
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    return F64X(mk(hi_np), mk(lo_np))


def shard_local_f64x(shape, mesh: Mesh, spec, fill) -> F64X:
    """Build a mesh-sharded F64X with **O(shard) host memory per process**.

    ``fill(idx)`` is called once per addressable shard with the global
    index (a tuple of slices into ``shape``) and must return that shard's
    numpy float64 block.  Nothing global is ever materialized — the
    north-star configs (BASELINE.json configs[4]: 131072^3, ~137 GB per
    f64 operand) are constructible on hosts with ordinary RAM.  The
    block's exact bits are split into the (hi, lo) planes here, so the
    carriage is as exact as :meth:`F64X.from_numpy`.

    ``fill`` may synthesize (random test operands from the global index),
    read from a memory-mapped file (``np.load(..., mmap_mode='r')[idx]``),
    or load per-shard chunks from a parallel filesystem.
    """
    sharding = NamedSharding(mesh, spec)
    cache = {}

    def block(idx):
        key = tuple((s.start, s.stop, s.step) for s in idx)
        if key not in cache:
            cache[key] = np.ascontiguousarray(fill(idx), dtype=np.float64).view(
                np.uint64
            )
        return cache[key]

    hi = jax.make_array_from_callback(
        tuple(shape), sharding,
        lambda idx: (block(idx) >> np.uint64(32)).astype(np.uint32),
    )
    lo = jax.make_array_from_callback(
        tuple(shape), sharding,
        lambda idx: (block(idx) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )
    cache.clear()
    return F64X(hi, lo)


def allgather_f64x(x: F64X) -> np.ndarray:
    """Gather a sharded F64X to a full numpy f64 array on every process."""
    from jax.experimental import multihost_utils

    hi = np.asarray(multihost_utils.process_allgather(x.hi, tiled=True), dtype=np.uint64)
    lo = np.asarray(multihost_utils.process_allgather(x.lo, tiled=True), dtype=np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.float64)
