"""Persistent XLA compilation cache.

Layer shapes change during ladder builds, so builds trigger many compiles; a
persistent cache makes repeat builds and benchmarks fast across processes.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set, and
nowhere else; otherwise at the fixed ``<checkout>/.jax_cache``.  Compiled
entries are found again only under the same path, so it must not move
between runs.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on (every compile is cached); returns its
    directory."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
