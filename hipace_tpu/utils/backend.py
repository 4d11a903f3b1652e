"""Persistent XLA compilation cache placement."""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path, because the directory is part of the
# cache key and a moving directory never hits (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """The cache directory in use: $JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself), else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache.

    The production step takes minutes to compile cold and seconds to load
    from the cache. With JAX_COMPILATION_CACHE_DIR set no directory is set
    here; otherwise the cache goes to DEFAULT_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
