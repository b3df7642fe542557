"""The persistent XLA compilation cache, configured in one place.

XLA autotunes every GEMM shape it compiles, so compiling the engine's
programs is a large share of a cold run; the persistent cache keeps them
across processes.  Its directory is part of each entry's key, so it is
one fixed path and never a temporary or per-process one.
"""

from __future__ import annotations

import os

#: the checkout (or install) root: the directory holding the package
CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: where the cache lives unless ``JAX_COMPILATION_CACHE_DIR`` says otherwise
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent compilation cache on; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing else is configured here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR` and keeps every program whose compile took
    at least ``min_compile_secs``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return DEFAULT_CACHE_DIR
