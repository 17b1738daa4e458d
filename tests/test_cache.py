"""Persistent compilation cache location (``utils/cache.py``)."""

import os

import jax

from parallel_hnsw.utils import cache


def test_cache_dir_defaults_to_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == cache.DEFAULT_CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.abspath(cache.__file__)))
    assert cache.DEFAULT_CACHE_DIR == os.path.join(
        os.path.dirname(root), ".jax_cache"
    )


def test_cache_follows_jax_compilation_cache_dir(monkeypatch, tmp_path):
    """With ``JAX_COMPILATION_CACHE_DIR`` set, the cache goes there and the
    default directory is neither configured nor created."""
    target = tmp_path / "xla-cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    before = jax.config.jax_compilation_cache_dir
    default_existed = os.path.exists(cache.DEFAULT_CACHE_DIR)
    try:
        assert cache.enable_compilation_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
        assert os.path.exists(cache.DEFAULT_CACHE_DIR) == default_existed
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
