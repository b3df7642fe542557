"""Test configuration: run JAX on CPU with 8 virtual devices and x64 on.

On the CPU backend every dtype is true IEEE, so engine arithmetic
(int32 splits, f32-triple recombination) is bit-reproducible and the
distributed path can be exercised on a virtual 8-device mesh.

``OZ_TEST_PLATFORM=gpu`` runs on the NVIDIA GPU instead (the CPU stays
available as ``jax.devices("cpu")`` for bitwise comparisons); the tests
marked ``gpu`` need it and skip without one — ``python chip_smoke.py``
runs them on the card.
"""

import os

import pytest

_plat = os.environ.get("OZ_TEST_PLATFORM", "cpu")
if _plat == "gpu":
    _plat = "cuda,cpu"
os.environ["JAX_PLATFORMS"] = _plat
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from ozimmu_tpu.utils.cache import enable_compile_cache  # noqa: E402

# A pytest plugin (jaxtyping) imports jax before this conftest runs, so the
# env var alone is snapshotted too early — set the config explicitly.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: at the tests' small shapes the slice schedule
# is unrolled, so the engine graphs are large and dominate test wall-time
# otherwise.
enable_compile_cache(min_compile_secs=0.5)


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs these on the card)")
    return gpus[0]
