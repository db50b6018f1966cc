"""Where JAX keeps its persistent compilation cache for this repo's scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and JAX reads
it itself; otherwise the cache lives at the fixed path ``.jax_cache`` in the
checkout. The path is part of the cache key, so a directory that moved
between runs would never hit. Call :func:`enable` before the first compile.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The environment's cache directory, else the in-checkout default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
