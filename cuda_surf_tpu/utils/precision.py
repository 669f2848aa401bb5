"""Matmul-precision control.

A default-precision float32 matmul may run in reduced precision on an
accelerator (TF32 on NVIDIA tensor cores, ~1e-3 relative) — wrong for
geometry linear algebra (rotation composition, normal equations) and
for scores compared against a reference.  Decorate accuracy-critical
functions so every dot/einsum they trace uses full float32 precision.
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Run fn under `jax.default_matmul_precision('float32')`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped
