"""Seeded synthetic bundle-adjustment problems (window-BA shaped)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .core import BAProblem, BAState


def window_problem(seed: int = 0):
    """A windowed-BA-shaped problem: 512 points in a unit cube 4 units
    ahead of 8 cameras on a 0.1-spaced baseline, every point seen by
    every camera, observations with N(0, 1e-3) noise (normalized
    coordinates).  The initial state is the truth with translations and
    points offset by N(0, 0.01) (camera 0 kept exact as the gauge).
    Returns (BAProblem, initial BAState, true BAState)."""
    n_cameras, n_points, noise, perturb = 8, 512, 1e-3, 0.01
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n_points, 3)) + [0, 0, 4]
    Rs = np.stack([np.eye(3)] * n_cameras)
    ts = np.stack([[0.1 * c, 0, 0] for c in range(n_cameras)])
    ci = np.tile(np.arange(n_cameras), (n_points, 1))
    xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
    uv = xc[..., :2] / xc[..., 2:] + rng.normal(0, noise,
                                                (n_points, n_cameras, 2))
    prob = BAProblem(jnp.asarray(ci, jnp.int32),
                     jnp.asarray(uv, jnp.float32),
                     jnp.ones((n_points, n_cameras), bool))
    t0 = ts + rng.normal(0, perturb, ts.shape)
    t0[0] = ts[0]
    X0 = X + rng.normal(0, perturb, X.shape)
    init = BAState(jnp.asarray(Rs, jnp.float32), jnp.asarray(t0, jnp.float32),
                   jnp.asarray(X0, jnp.float32))
    truth = BAState(jnp.asarray(Rs, jnp.float32), jnp.asarray(ts, jnp.float32),
                    jnp.asarray(X, jnp.float32))
    return prob, init, truth
