"""Persistent XLA compilation cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX itself keeps its cache
there and this module sets no other directory.  Otherwise the cache lives
at a fixed path inside the checkout (``<repo>/.jax_cache``, gitignored):
the path is part of the cache key, so a directory that moves never hits.
Safe to call multiple times.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_persistent_cache() -> None:
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir(), exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
