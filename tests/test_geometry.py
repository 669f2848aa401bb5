import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cuda_surf_tpu.geometry import (
    exp_so3, log_so3, exp_se3, ransac_essential, sampson_error,
    triangulate, recover_pose,
)


def _rotmat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_so3_roundtrip(rng):
    w = rng.normal(size=(20, 3)).astype(np.float32) * 0.8
    R = exp_so3(jnp.asarray(w))
    w2 = np.asarray(log_so3(R))
    np.testing.assert_allclose(w2, w, atol=1e-4)
    # orthonormality
    RtR = np.asarray(R @ jnp.swapaxes(R, -1, -2))
    np.testing.assert_allclose(RtR, np.tile(np.eye(3), (20, 1, 1)), atol=1e-5)


def _synthetic_pair(rng, n=200, noise=0.0, outliers=0.0):
    R = _rotmat([0.2, 1.0, 0.1], 0.15)
    t = np.array([1.0, 0.1, 0.2])
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    x1 = X[:, :2] / X[:, 2:]
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:]
    x1 += rng.normal(0, noise, x1.shape)
    x2 += rng.normal(0, noise, x2.shape)
    n_out = int(n * outliers)
    if n_out:
        x2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32), R, t


def test_triangulate_exact(rng):
    x1, x2, R, t = _synthetic_pair(rng)
    X = np.asarray(triangulate(jnp.asarray(R, dtype=jnp.float32),
                               jnp.asarray(t, dtype=jnp.float32),
                               jnp.asarray(x1), jnp.asarray(x2)))
    reproj = X[:, :2] / X[:, 2:]
    np.testing.assert_allclose(reproj, x1, atol=1e-3)


def test_ransac_recovers_pose():
    # local deterministic rng: the session fixture's stream depends on
    # test selection/order, and this test's 0.5 deg bound is tight
    # enough to flip on an unlucky draw
    x1, x2, R_true, t_true = _synthetic_pair(
        np.random.default_rng(3), noise=1e-4, outliers=0.3)
    valid = np.ones(len(x1), bool)
    res = jax.jit(ransac_essential, static_argnames=("n_hypotheses",))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
        jax.random.PRNGKey(0), n_hypotheses=256)
    n_inl = int(res.n_inliers)
    assert n_inl > 0.6 * len(x1)
    R, t = np.asarray(res.R, np.float64), np.asarray(res.t, np.float64)
    # rotation error
    dR = R @ R_true.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5
    # translation direction error (sign-resolved by cheirality); the linear
    # 8-point refit in float32 bottoms out at a couple of degrees here
    cosd = abs(t @ t_true) / (np.linalg.norm(t) * np.linalg.norm(t_true))
    assert np.degrees(np.arccos(np.clip(cosd, -1, 1))) < 3.0
    # inliers should exclude the planted outliers
    inl = np.asarray(res.inliers)
    assert inl[: int(0.3 * len(x1))].mean() < 0.1


def _essential(R, t):
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return E / np.linalg.norm(E)


@pytest.mark.parametrize("n_ok", [1, 3])
def test_ransac_finalists_skip_invalid_candidates(n_ok):
    """With fewer valid hypotheses than finalists, a not-ok slot never
    wins, even when its cost is the lowest."""
    from cuda_surf_tpu.geometry.epipolar import (_best_finalist,
                                                 project_essential)
    x1, x2, R, t = _synthetic_pair(np.random.default_rng(5), n=40)
    E_true = _essential(R, t)
    rng = np.random.default_rng(6)
    Es = np.stack([E_true + rng.normal(0, 1e-2, (3, 3)) for _ in range(40)])
    cand_ok = np.zeros(40, bool)
    cand_ok[[7, 20, 33][:n_ok]] = True
    Es[~cand_ok] = E_true                  # exact, but marked not-ok
    scores = np.where(cand_ok, 10, -1)
    E = np.asarray(_best_finalist(
        jnp.asarray(Es, jnp.float32), jnp.asarray(scores),
        jnp.asarray(cand_ok), jnp.asarray(x1), jnp.asarray(x2),
        jnp.ones(40, bool), 1e-4))
    allowed = [np.asarray(project_essential(jnp.asarray(e, jnp.float32)))
               for e in Es[cand_ok]]
    assert min(np.abs(E - a).max() for a in allowed) == 0.0


def test_ransac_5pt_few_matches():
    """A handful of exact matches: most five-point slots are not-ok, and
    the pose still comes out right."""
    x1, x2, R_true, t_true = _synthetic_pair(np.random.default_rng(8),
                                             n=8)
    res = jax.jit(ransac_essential,
                  static_argnames=("n_hypotheses", "solver"))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.ones(8, bool),
        jax.random.PRNGKey(2), n_hypotheses=3, solver="5pt")
    assert int(res.n_inliers) == 8
    dR = np.asarray(res.R, np.float64) @ R_true.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5


def test_sampson_zero_for_exact(rng):
    x1, x2, R, t = _synthetic_pair(rng)
    E = np.cross(t, np.eye(3)) @ R  # E = [t]_x R ... as (3,3)
    E = jnp.asarray(-np.cross(R.T @ -t, np.eye(3)) @ np.eye(3), jnp.float32)
    # build E directly: E = hat(t) @ R
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = jnp.asarray(tx @ R, jnp.float32)
    err = np.asarray(sampson_error(E, jnp.asarray(x1), jnp.asarray(x2)))
    assert err.max() < 1e-8


def test_five_point_minimal():
    """Nister 5-point solver recovers the exact E from 5 clean
    correspondences (reference has no minimal solver; SURVEY.md
    section 7 phase 7 north star)."""
    from cuda_surf_tpu.geometry.fivepoint import five_point
    rng = np.random.default_rng(7)
    fp = jax.jit(five_point)
    ok = 0
    trials = 20
    for _ in range(trials):
        R = _rotmat(rng.normal(size=3), rng.uniform(0.05, 0.6))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = rng.uniform(-1, 1, (5, 3)) + np.array([0, 0, 4.0])
        x1 = X[:, :2] / X[:, 2:]
        Xc2 = X @ R.T + t
        x2 = Xc2[:, :2] / Xc2[:, 2:]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E_true = tx @ R
        E_true /= np.linalg.norm(E_true)
        Es, valid = fp(jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32))
        Es, valid = np.asarray(Es), np.asarray(valid)
        best = min((min(np.linalg.norm(E - E_true), np.linalg.norm(E + E_true))
                    for E, v in zip(Es, valid) if v), default=np.inf)
        ok += best < 5e-3
    # float32 minimal solves occasionally lose a root; RANSAC absorbs that
    assert ok >= trials - 2, f"only {ok}/{trials} recovered"


def test_five_point_batched_shapes():
    from cuda_surf_tpu.geometry.fivepoint import five_point
    rng = np.random.default_rng(0)
    x1 = jnp.asarray(rng.normal(0, 0.3, (6, 5, 2)), jnp.float32)
    x2 = jnp.asarray(rng.normal(0, 0.3, (6, 5, 2)), jnp.float32)
    Es, valid = jax.jit(five_point)(x1, x2)
    assert Es.shape == (6, 20, 3, 3) and valid.shape == (6, 20)
    # all returned matrices are unit-norm and finite
    n = np.linalg.norm(np.asarray(Es).reshape(6, 20, -1), axis=-1)
    assert np.isfinite(np.asarray(Es)).all()
    np.testing.assert_allclose(n, 1.0, atol=1e-3)


@pytest.mark.slow
def test_ransac_5pt_high_outliers():
    """At 65% outliers the 5-point sampler still nails the pose with a
    modest hypothesis budget (w^5 = 0.5%/sample vs w^8 = 0.02%)."""
    x1, x2, R_true, t_true = _synthetic_pair(
        np.random.default_rng(11), n=300, noise=1e-4, outliers=0.65)
    valid = np.ones(len(x1), bool)
    res = jax.jit(ransac_essential,
                  static_argnames=("n_hypotheses", "solver"))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
        jax.random.PRNGKey(1), n_hypotheses=192, solver="5pt")
    assert int(res.n_inliers) > 0.28 * len(x1)
    R = np.asarray(res.R, np.float64)
    dR = R @ R_true.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.0
    # translation direction: float32 8-point refit on ~100 inliers
    # bottoms out around 5-6 degrees (cf. test_ransac_recovers_pose)
    t = np.asarray(res.t, np.float64)
    cosd = abs(t @ t_true) / (np.linalg.norm(t) * np.linalg.norm(t_true))
    assert np.degrees(np.arccos(np.clip(cosd, -1, 1))) < 8.0
