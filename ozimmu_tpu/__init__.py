"""ozimmu_tpu — Ozaki-scheme FP64 GEMM engine in JAX.

A JAX/XLA framework with the capabilities of enp1s0/ozIMMU (CUDA): FP64
(D/Z) GEMM emulated by error-free mantissa splitting into 3..18 int8
slices, all-pairs int8 matmuls with int32 accumulation (cuBLASLt int8
tensor-core GEMMs on an NVIDIA GPU), and deterministic extended-precision
recombination — plus auto split-count selection with a native-DGEMM
fallback, an FP32 demotion mode, a ``jnp.dot``/``einsum`` interceptor
(replacing the reference's LD_PRELOAD shim), and a distributed
2D-sharded path over device meshes.

Quick start::

    import numpy as np, ozimmu_tpu as oz
    a = np.random.rand(2048, 2048); b = np.random.rand(2048, 2048)
    c = oz.matmul(a, b, mode="fp64_int8_9")      # < 1e-15 residual
    mode = oz.auto_mode_select(a, b)              # pick ns from the data

    with oz.intercept.enable():                   # reroute jnp.dot/matmul
        ...
"""

from .types import (
    ComputeMode,
    ElementKind,
    Operation,
    INT8_MODES,
    MAX_NUM_SPLIT,
    MIN_NUM_SPLIT,
    get_compute_mode_name_str,
)
from .schedule import bits_per_int8, pair_schedule, group_schedule
from .core.f64x import F64X, as_f64x
from .core.api import (
    auto_mode_select,
    gemm,
    gemm_batched,
    matmul,
    warmup,
)
from .core.gemm import gemm_f64x, zgemm_f64x
from .core.handle import (
    Handle,
    create,
    destroy,
    default_handle,
    enable_profiling,
    disable_profiling,
    print_profiler_result,
    clear_profiler_result,
    reallocate_working_memory,
    set_auto_mantissa_loss_threshold,
    get_auto_mantissa_loss_threshold,
)
from .utils.profiling import device_trace
from . import hostref, linalg, schedule, testing, traced, types

__version__ = "0.1.0"

__all__ = [
    "ComputeMode",
    "ElementKind",
    "Operation",
    "F64X",
    "as_f64x",
    "INT8_MODES",
    "MIN_NUM_SPLIT",
    "MAX_NUM_SPLIT",
    "bits_per_int8",
    "pair_schedule",
    "group_schedule",
    "gemm",
    "gemm_batched",
    "matmul",
    "warmup",
    "gemm_f64x",
    "zgemm_f64x",
    "auto_mode_select",
    "get_compute_mode_name_str",
    "Handle",
    "create",
    "destroy",
    "default_handle",
    "enable_profiling",
    "device_trace",
    "disable_profiling",
    "print_profiler_result",
    "clear_profiler_result",
    "reallocate_working_memory",
    "set_auto_mantissa_loss_threshold",
    "get_auto_mantissa_loss_threshold",
    "hostref",
    "linalg",
    "schedule",
    "testing",
    "traced",
    "types",
    "__version__",
]
