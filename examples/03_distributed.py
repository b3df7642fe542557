import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""Multi-chip sharded DGEMM over a jax.sharding.Mesh.

Runs on 8 virtual CPU devices (JAX_PLATFORMS=cpu) or on the GPUs of one
host.  All cross-device traffic is int8 digit planes; results are
bit-identical to the single-device engine.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import numpy as np
import jax

# XLA_FLAGS only takes effect for clients created after a jax_platforms
# config update and before any device query — so re-apply the user's
# platform choice here.
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat:
    jax.config.update("jax_platforms", _plat)
jax.config.update("jax_enable_x64", True)

import ozimmu_tpu as oz
from ozimmu_tpu.parallel.gemm import make_mesh_2d, sharded_gemm

rng = np.random.default_rng(0)
a = rng.uniform(size=(256, 512))
b = rng.uniform(size=(512, 128))

mesh = make_mesh_2d()  # largest (x, y) grid over all devices
c = sharded_gemm(a, b, 9, mesh)
print("mesh:", mesh.devices.shape,
      "residual:", np.linalg.norm(c - a @ b) / np.linalg.norm(a @ b))

# bit-identical to single chip
c_local = oz.gemm(a, b, mode="fp64_int8_9")
print("bitwise == local:", np.array_equal(c.view(np.uint64), c_local.view(np.uint64)))

# full gemm contract on the mesh: alpha*(a@b) + beta*c, same exact
# epilogue as the single-chip engine (bitwise-identical)
c0 = rng.uniform(size=(256, 128))
c_ep = sharded_gemm(a, b, 9, mesh, alpha=2.0, beta=1.0, c=c0)
c_ep_local = oz.gemm(a, b, mode="fp64_int8_9", alpha=2.0, beta=1.0, c=c0)
print("epilogue bitwise == local:",
      np.array_equal(c_ep.view(np.uint64), c_ep_local.view(np.uint64)))

# distributed ZGEMM: 4-pass complex engine, int8-only traffic
za = rng.normal(size=(256, 512)) + 1j * rng.normal(size=(256, 512))
zb = rng.normal(size=(512, 128)) + 1j * rng.normal(size=(512, 128))
z = sharded_gemm(za, zb, 9, mesh)
z_local = oz.gemm(za, zb, mode="fp64_int8_9")
print("zgemm bitwise == local:", np.array_equal(z, z_local))

# Cannon-streamed variant for square meshes: q-fold lower peak memory,
# for problems whose gathered slabs would not fit in HBM
if len(jax.devices()) >= 4:
    sq = make_mesh_2d(4)
    c_ring = sharded_gemm(a, b, 9, sq, ring=True)
    print("ring bitwise == local:",
          np.array_equal(c_ring.view(np.uint64), c_local.view(np.uint64)))
else:
    print("ring demo needs >= 4 devices (run with JAX_PLATFORMS=cpu "
          "XLA_FLAGS=--xla_force_host_platform_device_count=8)")

# fully automatic: distributed AUTO mode selection (mesh-wide
# mantissa-loss estimator, identical selection to oz.auto_mode_select)
# plus automatic variant choice (summa / ring / k-sharded)
from ozimmu_tpu.parallel.gemm import sharded_auto_mode_select, sharded_gemm_auto

aw = a * np.exp2(rng.integers(-10, 10, a.shape).astype(float))
bw = b * np.exp2(rng.integers(-10, 10, b.shape).astype(float))
sel = sharded_auto_mode_select(aw, bw, mesh)
print("distributed AUTO picked:", sel.value,
      "(single-chip picks:", oz.auto_mode_select(aw, bw).value + ")")
c_auto = sharded_gemm_auto(aw, bw, "auto", mesh)
c_auto_local = oz.gemm(aw, bw, mode="fp64_int8_auto")
print("auto bitwise == local:",
      np.array_equal(c_auto.view(np.uint64), c_auto_local.view(np.uint64)))

# tall-contraction complex: routed to the 1D k-sharded ZGEMM
zk_a = rng.normal(size=(16, 4096)) + 1j * rng.normal(size=(16, 4096))
zk_b = rng.normal(size=(4096, 16)) + 1j * rng.normal(size=(4096, 16))
zk = sharded_gemm_auto(zk_a, zk_b, 10, mesh)
print("tall-k complex == local:",
      np.array_equal(zk, oz.gemm(zk_a, zk_b, mode="fp64_int8_10")))
