"""Where JAX keeps its persistent compilation cache — one rule for every
script that compiles for a measurement or a smoke run.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no path is
set here. Otherwise the cache goes to `.jax_cache/` at the root of the
checkout: a fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory (see the
    module docstring); returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
