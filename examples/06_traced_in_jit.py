import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""The in-jit functional API: engine calls inside YOUR jitted code.

No global interception, no host round-trips — traced.gemm composes like
any other jax op, and is bit-identical to the host API.
"""
import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

import ozimmu_tpu as oz
from ozimmu_tpu import traced

rng = np.random.default_rng(0)
a = jnp.asarray(rng.normal(size=(256, 256)))
b = jnp.asarray(rng.normal(size=(256, 256)))
c = jnp.asarray(rng.normal(size=(256, 256)))


@jax.jit
def power_step(a, b, c):
    """A composite jitted computation with two engine calls inside."""
    g = traced.gemm(a, b, alpha=2.0, beta=1.0, c=c, num_split=9)
    return traced.matmul(g, b), jnp.trace(g)


g2, tr = power_step(a, b, c)
ref_g = 2.0 * (np.asarray(a) @ np.asarray(b)) + np.asarray(c)
ref = ref_g @ np.asarray(b)
print("residual:", np.linalg.norm(np.asarray(g2) - ref) / np.linalg.norm(ref))
print("trace matches:", np.isclose(float(tr), np.trace(ref_g)))

# on CPU the traced path is bit-identical to the host API
host = oz.gemm(np.asarray(a), np.asarray(b), mode="fp64_int8_9",
               alpha=2.0, beta=1.0, c=np.asarray(c))
injit = np.asarray(jax.jit(
    lambda x, y, z: traced.gemm(x, y, alpha=2.0, beta=1.0, c=z)
)(a, b, c))
if jax.devices()[0].platform == "cpu":
    print("bitwise == host API:",
          np.array_equal(injit.view(np.uint64), host.view(np.uint64)))

# batched, vmapped
ab = jnp.stack([a, 2 * a])
bb = jnp.stack([b, b])
out = traced.gemm_batched(ab, bb)
print("batched ok:", out.shape)
