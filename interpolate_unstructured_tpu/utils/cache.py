"""Persistent XLA compile cache setup.

Compiling the large-mesh query and tracer programs takes seconds to
minutes; a disk-backed compilation cache lets a re-run skip it.  Tests
configure this in conftest.py; benchmarks, ``chip_smoke.py`` and user
scripts call :func:`enable_compile_cache`.
"""

from __future__ import annotations

import os

# Fixed in-checkout location (listed in .gitignore): the cache key
# includes the path, so a directory that moves between runs never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(path: str | None = None) -> str:
    """Turn on jax's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, jax already reads it and
    this function sets nothing.  Otherwise the cache goes to ``path``,
    by default ``.jax_cache`` at the repository root.  Safe to call
    multiple times and before/after backend init.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = path or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
