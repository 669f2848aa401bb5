import numpy as np
import jax.numpy as jnp

import oracle
from cuda_surf_tpu import SurfConfig, Surf
from cuda_surf_tpu.ops.matcher import match


def _to_sets(kps):
    v = np.asarray(kps.valid)
    idx = np.nonzero(v)[0]
    return {
        "x": np.asarray(kps.x)[idx], "y": np.asarray(kps.y)[idx],
        "scale": np.asarray(kps.scale)[idx],
        "strength": np.asarray(kps.strength)[idx],
        "laplace": np.asarray(kps.laplace)[idx],
        "ori": np.asarray(kps.ori)[idx],
    }, idx


def _match_rate(ax, ay, bx, by, tol=0.1):
    """Fraction of (ax, ay) points having a (bx, by) point within tol."""
    if len(ax) == 0:
        return 1.0
    d = np.hypot(ax[:, None] - bx[None, :], ay[:, None] - by[None, :])
    return float((d.min(axis=1) < tol).mean())


def test_upright_end_to_end_vs_oracle(small_image):
    cfg = SurfConfig(noctaves=3, max_pts=512, candidates_per_octave=512)
    surf = Surf(cfg)
    kps, desc = surf.detect_and_compute(small_image)
    got, idx = _to_sets(kps)
    want_pts, want_desc = oracle.detect_and_compute(small_image, cfg)
    assert len(want_pts) > 3
    assert len(got["x"]) == len(want_pts)
    wx = np.array([p.x for p in want_pts])
    wy = np.array([p.y for p in want_pts])
    assert _match_rate(got["x"], got["y"], wx, wy) == 1.0

    # descriptor parity: pair points by location, compare vectors
    d = np.hypot(got["x"][:, None] - wx[None, :], got["y"][:, None] - wy[None, :])
    pair = d.argmin(axis=1)
    desc_np = np.asarray(desc)[idx]
    for i, j in enumerate(pair):
        np.testing.assert_allclose(desc_np[i], want_desc[j], atol=5e-4)
    # laplace signs match
    wl = np.array([p.laplace for p in want_pts])
    assert (got["laplace"] == wl[pair]).all()
    # descriptors are unit-norm
    np.testing.assert_allclose(np.linalg.norm(desc_np, axis=1), 1.0, atol=1e-5)


def test_rotated_end_to_end_vs_oracle(small_image):
    cfg = SurfConfig(noctaves=2, upright=False, max_pts=256,
                     candidates_per_octave=512)
    surf = Surf(cfg)
    kps, desc = surf.detect_and_compute(small_image)
    got, idx = _to_sets(kps)
    want_pts, want_desc = oracle.detect_and_compute(small_image, cfg)
    assert len(got["x"]) == len(want_pts)
    wx = np.array([p.x for p in want_pts])
    wy = np.array([p.y for p in want_pts])
    d = np.hypot(got["x"][:, None] - wx[None, :], got["y"][:, None] - wy[None, :])
    pair = d.argmin(axis=1)
    wori = np.array([p.ori for p in want_pts])
    # orientations within a degree (atan2 approximation + fp divergence)
    dori = np.abs(got["ori"] - wori[pair])
    dori = np.minimum(dori, 2 * np.pi - dori)
    assert dori.max() < np.deg2rad(1.0)
    desc_np = np.asarray(desc)[idx]
    err = np.abs(desc_np - want_desc[pair]).max()
    assert err < 5e-3


def test_extended_descriptor_dim(small_image):
    cfg = SurfConfig(noctaves=2, extended=True, max_pts=128,
                     candidates_per_octave=256)
    surf = Surf(cfg)
    kps, desc = surf.detect_and_compute(small_image)
    assert desc.shape == (128, 128)
    v = np.asarray(kps.valid)
    assert v.any()
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(desc)[v], axis=1), 1.0, atol=1e-5)
    # value parity vs the independent NumPy oracle: the extended
    # channel-split (describeExtended, reference surfd.cu K19/K22
    # dyy/dxx-conditioned 8-way binning) paired point-by-point
    got, idx = _to_sets(kps)
    want_pts, want_desc = oracle.detect_and_compute(small_image, cfg)
    assert len(got["x"]) == len(want_pts)
    wx = np.array([p.x for p in want_pts])
    wy = np.array([p.y for p in want_pts])
    d = np.hypot(got["x"][:, None] - wx[None, :],
                 got["y"][:, None] - wy[None, :])
    pair = d.argmin(axis=1)
    np.testing.assert_allclose(np.asarray(desc)[idx], want_desc[pair],
                               atol=5e-4)


def test_rotated_extended_descriptor_vs_oracle(small_image):
    """Rotated + extended: the 128-d channel split composes with the
    orientation rotation (reference K22 describeRotExtended)."""
    cfg = SurfConfig(noctaves=2, upright=False, extended=True,
                     max_pts=128, candidates_per_octave=256)
    surf = Surf(cfg)
    kps, desc = surf.detect_and_compute(small_image)
    assert desc.shape == (128, 128)
    got, idx = _to_sets(kps)
    want_pts, want_desc = oracle.detect_and_compute(small_image, cfg)
    assert len(got["x"]) == len(want_pts) and len(want_pts) > 3
    wx = np.array([p.x for p in want_pts])
    wy = np.array([p.y for p in want_pts])
    d = np.hypot(got["x"][:, None] - wx[None, :],
                 got["y"][:, None] - wy[None, :])
    pair = d.argmin(axis=1)
    np.testing.assert_allclose(np.asarray(desc)[idx], want_desc[pair],
                               atol=5e-3)


def test_match_semantics(rng):
    d1 = rng.normal(size=(8, 64)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.concatenate([d1[3:4] + 0.01 * rng.normal(size=(1, 64)).astype(np.float32),
                         rng.normal(size=(15, 64)).astype(np.float32)])
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v1 = np.ones(8, bool)
    v2 = np.ones(16, bool)
    m = match(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
              jnp.asarray(v2), jnp.zeros(16), jnp.zeros(16))
    best, best_s, amb = oracle.match(d1, d2)
    np.testing.assert_array_equal(np.asarray(m.index), best)
    np.testing.assert_allclose(np.asarray(m.score), best_s, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(m.ambiguity), amb, rtol=1e-4)
    assert int(m.index[3]) == 0  # the planted near-duplicate


def test_match_ignores_invalid_columns(rng):
    d1 = rng.normal(size=(4, 64)).astype(np.float32)
    d2 = np.tile(d1[0], (6, 1)).astype(np.float32)
    v2 = np.array([False, False, True, True, True, True])
    m = match(jnp.asarray(d1), jnp.ones(4, bool), jnp.asarray(d2),
              jnp.asarray(v2), jnp.zeros(6), jnp.zeros(6))
    assert (np.asarray(m.index) >= 2).all()


def test_match_cross_check():
    import jax.numpy as jnp
    from cuda_surf_tpu.types import Keypoints
    from cuda_surf_tpu.ops.matcher import match_keypoints

    lrng = np.random.default_rng(5)
    d1 = lrng.normal(size=(32, 64)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    # set2 = permuted copies of set1 plus distractors similar to d1[0]
    perm = lrng.permutation(32)            # d2[j] == d1[perm[j]]
    d2 = np.concatenate([d1[perm], (d1[0] + 0.05 * lrng.normal(size=(4, 64))
                                    ).astype(np.float32)])
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    true_match = np.argsort(perm)          # set1 i -> set2 index

    kp1 = Keypoints.empty(32)
    kp1.valid = jnp.ones(32, bool)
    kp2 = Keypoints.empty(36)
    kp2.valid = jnp.ones(36, bool)
    m = match_keypoints(kp1, jnp.asarray(d1), kp2, jnp.asarray(d2))
    mc = match_keypoints(kp1, jnp.asarray(d1), kp2, jnp.asarray(d2),
                         cross_check=True)
    assert np.asarray(mc.valid).sum() <= np.asarray(m.valid).sum()
    ok = np.asarray(mc.valid)
    assert ok.sum() >= 28
    # every surviving cross-checked match is the true permutation pair
    assert (np.asarray(mc.index)[ok] == true_match[ok]).all()
