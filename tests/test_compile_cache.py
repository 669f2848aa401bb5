"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, one
fixed gitignored directory inside the checkout otherwise."""

import os

import pytest

from cuda_surf_tpu.utils import compile_cache


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""},
                                 {"JAX_COMPILATION_CACHE_DIR": "/x/cache"}])
def test_compile_cache_dir(env):
    got = compile_cache.compile_cache_dir(env)
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        assert got == env["JAX_COMPILATION_CACHE_DIR"]
    else:
        assert got == compile_cache.DEFAULT_DIR
        assert os.path.dirname(got) == compile_cache.REPO_ROOT


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(compile_cache.REPO_ROOT, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(compile_cache.DEFAULT_DIR) in ignored
