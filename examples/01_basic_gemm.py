import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""Basic emulated-FP64 GEMM: modes, accuracy, BLAS epilogue."""
import numpy as np
import jax

jax.config.update("jax_enable_x64", True)  # required
import ozimmu_tpu as oz

rng = np.random.default_rng(0)
a = rng.uniform(size=(2048, 2048))
b = rng.uniform(size=(2048, 2048))

# plain matmul at the headline mode
c = oz.matmul(a, b, mode="fp64_int8_9")
ref = a @ b
print("residual:", np.linalg.norm(c - ref) / np.linalg.norm(ref))

# BLAS-style epilogue with transposes
c2 = oz.gemm(a, b, mode="fp64_int8_9", op_a="T", alpha=2.0, beta=1.0, c=c)
print("epilogue ok:", np.allclose(c2, 2.0 * (a.T @ b) + c, rtol=1e-13))

# data-driven split count: wide-exponent inputs need more slices
wide = (rng.uniform(size=(1024, 1024)) - 0.5) * np.exp(6 * rng.standard_normal((1024, 1024)))
# default threshold 0.0 demands error-free splits -> falls back to dgemm;
# a small loss budget picks the smallest adequate slice count instead
print("auto, exact (0.0):", oz.auto_mode_select(wide, b[:1024, :1024]))
print("auto, 2-bit budget:", oz.auto_mode_select(wide, b[:1024, :1024], threshold=2.0))

# complex (ZGEMM)
z = oz.gemm(a[:512, :512] + 1j * b[:512, :512], b[:512, :512] - 1j * a[:512, :512],
            mode="fp64_int8_9")
print("zgemm done:", z.shape, z.dtype)
