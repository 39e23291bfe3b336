"""Persistent XLA compilation cache.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX keeps its cache there and this
module sets no directory.  Otherwise the cache lives at the fixed
`<checkout>/.jax_cache`: the directory is part of the cache key, so a fixed
path lets every later process of the same checkout reuse its compiles.
Called by `run_demo.main`, `chip_smoke.py` and the bench scripts; safe to
call more than once, and on any backend.
"""
from __future__ import annotations

import os

__all__ = ["enable_persistent_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable_persistent_cache() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
