"""Multi-process worker: 2D-sharded GEMM on a hybrid (one block per process) mesh.

Launched by tests/test_multiprocess.py as N processes x 4 virtual CPU
devices each.  Asserts the multi-process sharded result is BITWISE equal
to the single-chip engine — the same invariant the single-process
distributed tests enforce, now across a real process boundary
(jax.distributed + cross-process collectives).

Usage: python mp_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.core.gemm import _gemm_core, _zgemm_core  # noqa: E402
from ozimmu_tpu.parallel.gemm import sharded_gemm_fn, sharded_zgemm_fn  # noqa: E402
from ozimmu_tpu.parallel.launch import (  # noqa: E402
    allgather_f64x,
    make_mesh_2d_hybrid,
    replicated_f64x,
)

assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 4 * nproc, jax.device_count()
assert jax.local_device_count() == 4

mesh = make_mesh_2d_hybrid()
x, y = mesh.devices.shape
assert x * y == 4 * nproc
m, n = 8 * x, 8 * y
k = 16 * x * y
rng = np.random.default_rng(0)
a = rng.uniform(size=(m, k))
b = rng.uniform(size=(k, n))
c = rng.uniform(size=(m, n))
spec = P("x", "y")

A = replicated_f64x(a, mesh, spec)
B = replicated_f64x(b, mesh, spec)
C = replicated_f64x(c, mesh, spec)
fn = jax.jit(sharded_gemm_fn(mesh, 9, k, alpha=2.0, beta=-0.5))
out = fn(A, B, C)
got = allgather_f64x(out).reshape(m, n)
ref = (
    _gemm_core(F64X.from_numpy(a), F64X.from_numpy(b), 9, 2.0, -0.5, F64X.from_numpy(c))
    .to_numpy()
    .reshape(m, n)
)
assert np.array_equal(got.view(np.uint64), ref.view(np.uint64)), (
    "multi-process DGEMM != single-chip engine bitwise"
)

# distributed 4-pass complex engine across the process boundary
za = rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))
zb = rng.normal(size=(k, n)) + 1j * rng.normal(size=(k, n))
zfn = jax.jit(sharded_zgemm_fn(mesh, 9, k))
zre, zim = zfn(
    replicated_f64x(za.real, mesh, spec),
    replicated_f64x(za.imag, mesh, spec),
    replicated_f64x(zb.real, mesh, spec),
    replicated_f64x(zb.imag, mesh, spec),
)
zgot = allgather_f64x(zre).reshape(m, n) + 1j * allgather_f64x(zim).reshape(m, n)
rre, rim = _zgemm_core(
    F64X.from_numpy(np.ascontiguousarray(za.real)),
    F64X.from_numpy(np.ascontiguousarray(za.imag)),
    F64X.from_numpy(np.ascontiguousarray(zb.real)),
    F64X.from_numpy(np.ascontiguousarray(zb.imag)),
    9,
    1.0 + 0j,
    0.0 + 0j,
)
zref = rre.to_numpy().reshape(m, n) + 1j * rim.to_numpy().reshape(m, n)
assert np.array_equal(
    zgot.view(np.uint64), np.ascontiguousarray(zref).view(np.uint64)
), "multi-process ZGEMM != single-chip engine bitwise"

# shard-local feeding (round 5): every process synthesizes ONLY its
# addressable shards from the global index — the O(shard)-host-memory
# path that makes the north-star sizes constructible — then the
# presharded entry runs the engine without any host materialization.
# Must be bitwise identical to the dense-fed single-chip engine.
from ozimmu_tpu.parallel.gemm import sharded_gemm_presharded  # noqa: E402
from ozimmu_tpu.parallel.launch import shard_local_f64x  # noqa: E402

A_sl = shard_local_f64x((m, k), mesh, spec, lambda idx: a[idx])
B_sl = shard_local_f64x((k, n), mesh, spec, lambda idx: b[idx])
out_ps = sharded_gemm_presharded(A_sl, B_sl, 9, mesh)
got_ps = allgather_f64x(out_ps).reshape(m, n)
ref_ps = (
    _gemm_core(F64X.from_numpy(a), F64X.from_numpy(b), 9, 1.0, 0.0)
    .to_numpy()
    .reshape(m, n)
)
assert np.array_equal(got_ps.view(np.uint64), ref_ps.view(np.uint64)), (
    "multi-process presharded GEMM != single-chip engine bitwise"
)

print(f"MP-OK {pid}", flush=True)
