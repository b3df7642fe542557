"""Mixed-precision iterative refinement: the classic consumer of emulated
FP64 GEMM (the reference paper's motivating HPC workload).

Solve A x = b by factorizing in fast low precision (f32) and driving
the error down with residuals computed in emulated f64 on the int8
engine — each refinement step gains ~p_low digits until f64-level accuracy.
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax

jax.config.update("jax_enable_x64", True)
import ozimmu_tpu as oz

rng = np.random.default_rng(0)
N = 1024
A = rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)  # well-conditioned
x_true = rng.standard_normal((N, 1))
b = (A.astype(np.longdouble) @ x_true.astype(np.longdouble)).astype(np.float64)

# --- low-precision factorization (plain numpy f32 LU, no pivd demo) -------
A32 = A.astype(np.float32)
import numpy.linalg as la

# factor once in f32 via Doolittle through numpy's solve on f32 (demo-grade)
def solve_f32(rhs):
    return la.solve(A32, rhs.astype(np.float32)).astype(np.float64)

x = solve_f32(b)
print("it  0: rel f32 solve error:", la.norm(x - x_true) / la.norm(x_true))

for it in range(1, 6):
    # residual in emulated f64 on the int8 engine — the step that needs
    # f64-accurate GEMM
    r = b - oz.matmul(A, x, mode="fp64_int8_9")
    x = x + solve_f32(r)
    err = la.norm(x - x_true) / la.norm(x_true)
    print(f"it {it:2d}: rel error: {err:.3e}")
    if err < 1e-14:
        print("converged to f64 accuracy")
        break
