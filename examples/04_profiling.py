import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""Profiling surfaces: phase breakdown, per-call CULiP lines, device traces."""
import os
import numpy as np
import jax

jax.config.update("jax_enable_x64", True)
import ozimmu_tpu as oz

rng = np.random.default_rng(0)
a = rng.uniform(size=(1024, 1024))
b = rng.uniform(size=(1024, 1024))

# 1. phase breakdown (the reference's time_breakdown profiler): the engine
#    runs staged (split / matmul / epilogue as separate dispatches)
h = oz.create()
oz.enable_profiling(h)
oz.gemm(a, b, mode="fp64_int8_9", handle=h)
oz.gemm(a, b, mode="fp64_int8_9", handle=h)
oz.print_profiler_result(h, tag="demo")          # human-readable
oz.print_profiler_result(h, tag="demo", csv=True)  # CSV rows
oz.disable_profiling(h)

# 2. per-call wall-clock lines (reference CULiP):
#    OZIMMU_ENABLE_CULIP_PROFILING=1 prints one line per intercepted call

# 3. deep kernel timeline -> TensorBoard/Perfetto
with oz.device_trace("oz_trace"):
    oz.matmul(a, b, mode="fp64_int8_9")
print("trace written to ./oz_trace")
