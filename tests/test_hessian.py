import functools

import pytest

import numpy as np
import jax
import jax.numpy as jnp

import oracle
from cuda_surf_tpu.config import SurfConfig
from cuda_surf_tpu.ops.hessian import response_pyramid
from cuda_surf_tpu.ops.integral import integral_image


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _pyramid(img, cfg, h, w):
    return response_pyramid(integral_image(img), cfg, h, w)


def test_schedule_octave0():
    cfg = SurfConfig()
    sched = cfg.hessian_schedule(960, 1280)
    o0 = sched[0]
    assert o0.octave == 1 and o0.init_scale == 0
    assert [sp.mask_size for sp in o0.scales] == [3, 5, 7, 9, 11]
    assert [sp.border1 for sp in o0.scales] == [6, 6, 6, 7, 9]
    assert o0.borders == (6, 6, 6, 6, 7)
    assert o0.maximum_borders() == [7, 8]
    o1 = sched[1]
    assert o1.octave == 2 and o1.init_scale == 2
    assert [sp.mask_size for sp in o1.scales] == [15, 19, 23]
    assert o1.borders[:2] == (8, 8)


def test_pyramid_matches_oracle(small_image):
    cfg = SurfConfig(noctaves=3)
    h, w = small_image.shape
    ii_np = oracle.integral_image(small_image)
    want = oracle.response_pyramid(ii_np, cfg, h, w)
    got = _pyramid(jnp.asarray(small_image), cfg, h, w)
    assert len(got) == 3
    for o in range(3):
        g = np.asarray(got[o])
        assert g.shape == want[o].shape
        np.testing.assert_allclose(g, want[o], rtol=1e-6, atol=5e-7)


def test_cross_octave_decimation(small_image):
    cfg = SurfConfig(noctaves=2)
    h, w = small_image.shape
    got = _pyramid(jnp.asarray(small_image), cfg, h, w)
    o0, o1 = np.asarray(got[0]), np.asarray(got[1])
    oh, ow = o1.shape[1:]
    np.testing.assert_array_equal(o1[0], o0[cfg.max_scale - 3, :2*oh:2, :2*ow:2])
    np.testing.assert_array_equal(o1[1], o0[cfg.max_scale - 1, :2*oh:2, :2*ow:2])


@pytest.mark.parametrize("mode", ["doubled", "init_mask_15"])
def test_pyramid_modes_match_oracle(small_image, mode):
    """The strided-slice pyramid against the oracle in the 2x-upsampled
    mode (sampling 4 on the doubled integral) and with the 15x15 initial
    mask (init_lobe 5, max_scale 7)."""
    kw = (dict(doubled=True, noctaves=3) if mode == "doubled"
          else dict(init_mask_size=15, noctaves=2))
    cfg = SurfConfig(**kw)
    h, w = small_image.shape
    ii_np = oracle.integral_image(small_image, cfg.doubled)
    want = oracle.response_pyramid(ii_np, cfg, h, w)
    got = jax.jit(lambda im: response_pyramid(
        integral_image(im, cfg.doubled), cfg, h, w))(jnp.asarray(small_image))
    assert len(got) == cfg.noctaves
    for o in range(cfg.noctaves):
        g = np.asarray(got[o])
        assert g.shape == want[o].shape == (cfg.max_scale,
                                            *cfg.octave_shapes(h, w)[o])
        assert np.abs(want[o]).max() > 0
        np.testing.assert_allclose(g, want[o], rtol=1e-6, atol=5e-7)
