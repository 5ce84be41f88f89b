"""Persistent XLA compilation cache shared by the benchmark, the CLIs and
chip_smoke.py."""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".bench_cache", "xla_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to the fixed path
    ``<checkout>/.bench_cache/xla_cache`` (the path is part of the cache
    key's lookup, so it must not move between runs)."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return DEFAULT_CACHE_DIR
