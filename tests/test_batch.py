"""Batched (throughput) frontend parity: detect_and_compute_batch must
reproduce the single-frame pipeline per frame.

The batch path runs the keypoint stages once over the union of all
frames' candidates and describes all frames' keypoints in one call over
frame-stacked integral images (frontend.py: detect_and_compute_batch);
the reference has no batch mode (one frame per call, main.cpp:241-245),
so the contract here is internal consistency with the single-frame
path, which is itself oracle-tested (test_reference_oracle /
test_golden_fixture).

Descriptors are compared at 2e-6: the binning reductions can be fused
differently by XLA in the two program contexts (reduction order is not
bit-stable across fusions).  Keypoint coordinates are exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cuda_surf_tpu import SurfConfig
from cuda_surf_tpu.frontend import detect_and_compute, detect_and_compute_batch


def _frames(n, h=96, w=160, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w)) * 255).astype(np.uint8) for _ in range(n)]


def _assert_batch_matches(frames, cfg, atol):
    imgs = jnp.asarray(np.stack(frames))
    kb, db = jax.jit(lambda im: detect_and_compute_batch(im, cfg))(imgs)
    for i, f in enumerate(frames):
        k1, d1 = jax.jit(lambda im: detect_and_compute(im, cfg))(
            jnp.asarray(f))
        n = int(k1.count)
        assert n == int(kb.count[i])
        # valid slots must match the single-frame path exactly; the
        # batch path zero-fills its padding slots (types.compact's
        # padding contract) where the single-frame path leaves the
        # makePoint of zeroed coords there (garbage +-1 laplace), so
        # padding is compared against zero instead.
        for fld in ("x", "y", "scale", "laplace"):
            a1 = np.asarray(getattr(k1, fld))
            ab = np.asarray(getattr(kb, fld)[i])
            np.testing.assert_array_equal(a1[:n], ab[:n], err_msg=fld)
            assert not ab[n:].any(), fld
        np.testing.assert_allclose(np.asarray(d1), np.asarray(db[i]),
                                   atol=atol)


def test_batch_parity_xla_path():
    cfg = SurfConfig(noctaves=2, thresh=1.0, upright=True, max_pts=256,
                     candidates_per_octave=512)
    _assert_batch_matches(_frames(3), cfg, atol=2e-6)


def test_batch_parity_single_frame():
    # B=1: the stacked stages degenerate to the single-frame layout
    cfg = SurfConfig(noctaves=2, thresh=1.0, upright=True, max_pts=256,
                     candidates_per_octave=512)
    _assert_batch_matches(_frames(1, seed=4), cfg, atol=2e-6)


def test_batch_rotated_falls_back():
    cfg = SurfConfig(noctaves=2, thresh=1.0, upright=False, max_pts=128,
                     candidates_per_octave=512)
    frames = _frames(2)
    imgs = jnp.asarray(np.stack(frames))
    kb, db = jax.jit(lambda im: detect_and_compute_batch(im, cfg))(imgs)
    k1, d1 = jax.jit(lambda im: detect_and_compute(im, cfg))(
        jnp.asarray(frames[1]))
    assert int(k1.count) == int(kb.count[1])
    np.testing.assert_allclose(np.asarray(d1), np.asarray(db[1]), atol=2e-6)
