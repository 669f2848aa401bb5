"""Persistent XLA compilation cache placement.

A cold process compiles every program of the pipeline again; the cache
lets later processes skip that.  The directory is part of the cache's
key, so it must not move between runs: `JAX_COMPILATION_CACHE_DIR` when
it is set, otherwise one fixed directory inside the checkout (listed in
`.gitignore`).  No other location is ever used.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The cache directory for this environment (os.environ by default)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return that directory.  Call before the first compilation."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
