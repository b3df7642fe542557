"""Multi-process (multi-host) sharded DGEMM demo.

On a real cluster, each host runs (with OZIMMU_COORDINATOR,
OZIMMU_NUM_PROCS and OZIMMU_PROC_ID exported):

    from ozimmu_tpu.parallel import launch
    launch.initialize()
    mesh = launch.make_mesh_2d_hybrid() # one device block per process
    ... sharded_gemm(a, b, 9, mesh) ...

For a laptop demo, this script RE-LAUNCHES ITSELF as 2 processes x 4
virtual CPU devices (the stand-in for 2 hosts x 4 chips) connected via
``jax.distributed``, and each process verifies the gathered result is
bitwise-identical to the single-chip engine.

Run: python examples/07_multiprocess.py
"""

import os
import socket
import subprocess
import sys

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))


def parent():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    nproc = 2
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # workers pin their own CPU platform
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, HERE, str(i), str(nproc), str(port)], env=env)
        for i in range(nproc)
    ]
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        raise SystemExit(f"worker return codes: {rcs}")
    print("both processes agreed bitwise with the single-chip engine")


def worker(pid: int, nproc: int, port: str):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
    )

    import numpy as np
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, ROOT)
    from ozimmu_tpu.core.f64x import F64X
    from ozimmu_tpu.core.gemm import _gemm_core
    from ozimmu_tpu.parallel.gemm import sharded_gemm_fn
    from ozimmu_tpu.parallel.launch import (
        allgather_f64x,
        make_mesh_2d_hybrid,
        replicated_f64x,
    )

    mesh = make_mesh_2d_hybrid()  # (x, y); process blocks outer on x
    x, y = mesh.devices.shape
    m, n, k = 16 * x, 16 * y, 512
    rng = np.random.default_rng(0)  # same data on every process
    a = rng.uniform(size=(m, k))
    b = rng.uniform(size=(k, n))

    A = replicated_f64x(a, mesh, P("x", "y"))
    B = replicated_f64x(b, mesh, P("x", "y"))
    out = jax.jit(sharded_gemm_fn(mesh, 9, k))(A, B)
    got = allgather_f64x(out).reshape(m, n)

    ref = _gemm_core(F64X.from_numpy(a), F64X.from_numpy(b), 9, 1.0, 0.0).to_numpy()
    assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))
    if pid == 0:
        r = np.linalg.norm(got - a @ b) / np.linalg.norm(a @ b)
        print(f"process {pid}/{nproc}: mesh {x}x{y} over "
              f"{jax.process_count()} processes, residual {r:.2e}, "
              "bitwise == single-chip")


if __name__ == "__main__":
    if len(sys.argv) == 4:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        parent()
