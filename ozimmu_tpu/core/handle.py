"""Engine handle: configuration, profiler, compile-cache warm-up.

API-parity layer for the reference handle (include/ozimmu/ozimmu.hpp:47-73,
src/handle.cu).  The CUDA handle owned a cuBLAS sub-handle, a stream and a
grow-only device arena; under JAX/XLA all of that belongs to the runtime,
so this handle keeps only:

  * interception thresholds (env ``OZIMMU_INTERCEPT_THRESHOLD_{M,N,K}``,
    default 1024 — reference handle.cu:25-30),
  * the auto-mode average-mantissa-loss threshold (default 0.0 —
    reference handle.hpp:26, env at cublas.cu:72-83),
  * the phase profiler (reference handle.hpp:16),
  * a default compute mode.

``reallocate_working_memory(handle, gemm_list)`` keeps its reference
meaning "make these GEMM shapes cheap to launch" — under XLA that is
ahead-of-time compilation, so it warms the jit cache for every listed
shape and returns the estimated device working set in bytes
(reference handle.cu:95-144 semantics).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..schedule import working_set_bytes
from ..types import ComputeMode, ComputeModeLike, ElementKind, Operation
from ..utils.env import env_compute_mode, env_float, env_int
from ..utils.log import log
from ..utils.profiling import PhaseProfiler

#: (op_a, op_b, m, n, k, element_kind, compute_mode) — reference
#: ``gemm_params_t`` (ozimmu.hpp:62-66).
GemmParams = Tuple[Operation, Operation, int, int, int, ElementKind, ComputeMode]
GemmList = List[GemmParams]


@dataclasses.dataclass
class Handle:
    intercept_threshold_m: int = 1024
    intercept_threshold_n: int = 1024
    intercept_threshold_k: int = 1024
    avg_mantissa_loss_threshold: float = 0.0
    default_mode: Optional[ComputeMode] = None
    profiler: PhaseProfiler = dataclasses.field(default_factory=PhaseProfiler)
    #: advisory working-memory floor set by the bytes overload of
    #: reallocate_working_memory (reference handle.cu:63-93).  XLA owns
    #: real allocation; this records the caller's reservation intent and
    #: is grow-only, like the reference arena.
    working_memory_bytes: int = 0

    def resolve_mode(self, mode: Optional[ComputeModeLike]) -> ComputeMode:
        """Explicit arg > handle default > env OZIMMU_COMPUTE_MODE > auto."""
        if mode is not None:
            return ComputeMode.parse(mode)
        if self.default_mode is not None:
            return self.default_mode
        env = env_compute_mode()
        if env is not None:
            return ComputeMode.parse(env)
        return ComputeMode.FP64_INT8_AUTO


_global_handle: Optional[Handle] = None


def create() -> Handle:
    """Create a handle with env-derived defaults (reference handle.cu:6-33)."""
    log("Initializing ozIMMU handle")
    h = Handle(
        intercept_threshold_m=env_int("OZIMMU_INTERCEPT_THRESHOLD_M", 1024),
        intercept_threshold_n=env_int("OZIMMU_INTERCEPT_THRESHOLD_N", 1024),
        intercept_threshold_k=env_int("OZIMMU_INTERCEPT_THRESHOLD_K", 1024),
        avg_mantissa_loss_threshold=env_float(
            "OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD", 0.0
        ),
    )
    return h


def destroy(handle: Handle) -> int:
    """Parity no-op (XLA owns all device state) — reference handle.cu:35-52."""
    log("Destroying ozIMMU handle")
    handle.profiler.clear()
    return 0


def default_handle() -> Handle:
    global _global_handle
    if _global_handle is None:
        _global_handle = create()
    return _global_handle


def enable_profiling(handle: Handle) -> None:
    handle.profiler.enable()


def disable_profiling(handle: Handle) -> None:
    handle.profiler.disable()


def print_profiler_result(handle: Handle, tag: str = "", csv: bool = False) -> None:
    handle.profiler.print_result(tag, csv)


def clear_profiler_result(handle: Handle) -> None:
    handle.profiler.clear()


def set_auto_mantissa_loss_threshold(handle: Handle, threshold: float) -> None:
    handle.avg_mantissa_loss_threshold = float(threshold)


def get_auto_mantissa_loss_threshold(handle: Handle) -> float:
    return handle.avg_mantissa_loss_threshold


def reallocate_working_memory(handle: Handle, gemm_list) -> int:
    """Warm the compile cache for the listed GEMMs; return est. bytes.

    The reference grows a device arena to the max working set
    (handle.cu:95-144); XLA allocates per-computation, so the actionable
    equivalent is AOT compilation of each (shape, mode) so later calls
    don't pay the (large) first-compile cost.

    Bytes overload (reference handle.cu:63-93): passing an ``int`` grows
    the handle's advisory reservation instead — under XLA there is no
    arena to resize, so the request is recorded grow-only (exactly the
    reference's no-op-when-smaller behavior) and logged; returns the
    current reservation.
    """
    from . import api  # local import to avoid a cycle

    if isinstance(gemm_list, int):
        size = int(gemm_list)
        if size > handle.working_memory_bytes:
            handle.working_memory_bytes = size
            log(f"Reallocated working memory advisory to {size} B")
        else:
            log(
                f"Working memory advisory kept at {handle.working_memory_bytes} B"
                f" (requested {size} B; grow-only, reference handle.cu:68-72)"
            )
        return handle.working_memory_bytes

    max_bytes = 0
    for op_a, op_b, m, n, k, kind, mode in gemm_list:
        mode = ComputeMode.parse(mode)
        if isinstance(kind, str):
            kind = ElementKind(kind) if kind in ("real", "complex") else (
                ElementKind.COMPLEX if kind.startswith("c") else ElementKind.REAL
            )
        if mode.is_int8:
            max_bytes = max(
                max_bytes,
                working_set_bytes(
                    m, n, k, mode.num_split, complex_=(kind == ElementKind.COMPLEX)
                ),
            )
        api.warmup(m, n, k, mode, kind, handle=handle)
    log(f"Warmed up for working set of {max_bytes} B")
    return max_bytes
