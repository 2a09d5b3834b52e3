"""Persistent XLA compilation cache (checkpoint/resume equivalent for
compiles; SURVEY.md section 5).

Compiled executables are kept across processes so repeat CLI/bench runs
skip recompilation. Where the cache lives:

- ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself; nothing
  else is configured in code);
- otherwise ``<checkout>/.jax_cache/`` -- a fixed path inside the source
  tree (git-ignored), since the cache is keyed by it.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compilation_cache", "cache_dir"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory :func:`enable_compilation_cache` uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Enable the persistent compilation cache; returns the cache dir."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
