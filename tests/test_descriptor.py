"""Gather describe and orientation paths against the NumPy oracle, on
hand-placed keypoints: the reference's describeUR* / describeApprox*
and assignOrientationApprox semantics (tests/oracle.py) in every mode,
at the border, at large sampling steps, and frame-stacked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from cuda_surf_tpu import SurfConfig
from cuda_surf_tpu.ops.descriptor import describe
from cuda_surf_tpu.ops.integral import integral_image
from cuda_surf_tpu.ops.orientation import assign_orientations


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110 + 30 * np.sin(xx / 11.0) * np.cos(yy / 8.0)
    for _ in range(40):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s, a = rng.uniform(2, 14), rng.uniform(-90, 90)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


H, W = 240, 320

# (x, y, scale) keypoints per case; orientations are drawn per point
_CASES = {
    # mid-image, the reference demo's typical scales
    "doubled": dict(cfg=dict(doubled=True, noctaves=3),
                    pts=[(60.3, 70.6, 2.1), (150.8, 120.2, 3.4),
                         (230.5, 90.1, 5.0)]),
    "doubled_rotated": dict(cfg=dict(doubled=True, upright=False,
                                     noctaves=3),
                            pts=[(61.2, 71.7, 2.3), (160.4, 118.9, 3.9),
                                 (240.6, 150.3, 4.6)]),
    "extended_upright": dict(cfg=dict(extended=True),
                             pts=[(80.4, 60.5, 2.6), (170.1, 140.7, 4.4),
                                  (250.9, 170.2, 7.3)]),
    # sampling windows that cross the image edge
    "border": dict(cfg=dict(),
                   pts=[(3.2, 40.7, 2.0), (316.6, 100.1, 3.1),
                        (120.5, 1.4, 4.2), (200.3, 238.8, 2.7)]),
    # step = round(1.65 * scale / 2) >= 4
    "large_scale": dict(cfg=dict(noctaves=4),
                        pts=[(160.5, 120.4, 5.2), (140.2, 110.9, 9.7),
                             (170.8, 130.1, 13.5)]),
}


@pytest.mark.parametrize("mode", sorted(_CASES))
def test_describe_matches_oracle(mode):
    case = _CASES[mode]
    cfg = SurfConfig(max_pts=8, **case["cfg"])
    img = _texture(H, W, seed=len(mode))
    ii = np.asarray(integral_image(jnp.asarray(img), cfg.doubled))
    rng = np.random.default_rng(7)
    pts = [oracle.OraclePoint(x=x, y=y, scale=s, strength=0.0, laplace=1,
                              octave=0,
                              ori=0.0 if cfg.upright
                              else float(rng.uniform(-np.pi, np.pi)))
           for (x, y, s) in case["pts"]]
    want = np.stack([oracle.describe(ii, cfg, p) for p in pts])

    f = lambda a: jnp.asarray(np.array(a, np.float32))
    got = jax.jit(lambda ii_, x, y, s, o: describe(
        ii_, cfg, x, y, s, o, jnp.ones(x.shape, bool)))(
        jnp.asarray(ii), f([p.x for p in pts]), f([p.y for p in pts]),
        f([p.scale for p in pts]), f([p.ori for p in pts]))
    assert got.shape == (len(pts), cfg.nfeatures)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)


@pytest.mark.parametrize("extended", [False, True])
def test_frame_stacked_describe_matches_per_frame(extended):
    """`row_base` mode (the batched frontend's one describe call over B
    stacked integral images) reproduces per-frame describe."""
    cfg = SurfConfig(max_pts=4, extended=extended)
    frames = [_texture(H, W, seed=s) for s in (11, 12, 13)]
    iis = [integral_image(jnp.asarray(f)) for f in frames]
    ih, iw = iis[0].shape
    slab = -(-ih // 32) * 32
    stack = jnp.concatenate([jnp.pad(ii, ((0, slab - ih), (0, 0)))
                             for ii in iis])
    x = jnp.asarray([4.5, 100.2, 300.7, 150.1], jnp.float32)
    y = jnp.asarray([120.3, 3.1, 200.6, 236.2], jnp.float32)
    s = jnp.asarray([2.2, 3.1, 6.4, 2.8], jnp.float32)
    zero = jnp.zeros_like(x)
    valid = jnp.ones(x.shape, bool)
    B = len(frames)
    tile = lambda a: jnp.tile(a, B)
    stacked = describe(stack, cfg, tile(x), tile(y), tile(s), tile(zero),
                       tile(valid),
                       row_base=jnp.repeat(jnp.arange(B) * slab, len(x)),
                       frame_hw=(ih, iw))
    for f, ii in enumerate(iis):
        single = describe(ii, cfg, x, y, s, zero, valid)
        np.testing.assert_allclose(
            np.asarray(stacked[f * len(x):(f + 1) * len(x)]),
            np.asarray(single), atol=1e-6)


@pytest.mark.parametrize("scale", [1.6, 2.5, 4.0, 7.5])
def test_orientation_matches_oracle(scale):
    cfg = SurfConfig(upright=False, noctaves=4, max_pts=6)
    img = _texture(H, W, seed=int(scale * 10))
    ii = np.asarray(integral_image(jnp.asarray(img)))
    rng = np.random.default_rng(int(scale * 100))
    xs = rng.uniform(20, W - 20, 6).astype(np.float32)
    ys = rng.uniform(20, H - 20, 6).astype(np.float32)
    want = np.array([oracle.assign_orientation(
        ii, cfg, oracle.OraclePoint(x=float(x), y=float(y), scale=scale,
                                    strength=0.0, laplace=1, octave=0))
        for x, y in zip(xs, ys)])
    got = jax.jit(lambda ii_, x, y, s: assign_orientations(
        ii_, cfg, x, y, s, jnp.ones(x.shape, bool)))(
        jnp.asarray(ii), jnp.asarray(xs), jnp.asarray(ys),
        jnp.full(xs.shape, scale, jnp.float32))
    d = np.abs(np.asarray(got) - want)
    d = np.minimum(d, 2 * np.pi - d)
    assert d.max() < 1e-4, d
