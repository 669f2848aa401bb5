"""Reference-true golden validation against the native C++ oracle.

native/surforacle.cpp is an independent scalar re-derivation of the
reference pipeline's math (the role of the reference's own CPU host
mirrors, surfd.cu:3082-3186 / 2915-3051): it shares no code with the
JAX framework OR with tests/oracle.py, so agreement here
cross-validates both.  The golden counts (2739 / 3443 on the reference
stereo fixtures) asserted by test_golden_fixture are reproduced by this
binary from first principles."""

import os
import subprocess

import numpy as np
import pytest

from conftest import REFERENCE_DATA
from cuda_surf_tpu import Surf, SurfConfig
from cuda_surf_tpu.io.oracle import build_oracle, run_oracle

_LEFT = os.path.join(REFERENCE_DATA, "left.pgm")
_RIGHT = os.path.join(REFERENCE_DATA, "right.pgm")


@pytest.fixture(scope="module", autouse=True)
def oracle_binary():
    try:
        build_oracle()
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"no C++ toolchain for the native oracle: {e!r}")


def _compare(image, image_path, cfg, *flags, check_ori=False):
    surf = Surf(cfg)
    kps, d = surf.detect_and_compute(image)
    v = np.asarray(kps.valid)
    okp, od = run_oracle(image_path, *flags)
    assert int(kps.count) == len(okp)            # exact count parity
    fx, fy = np.asarray(kps.x)[v], np.asarray(kps.y)[v]
    D = ((fx[:, None] - okp[None, :, 0]) ** 2
         + (fy[:, None] - okp[None, :, 1]) ** 2)
    j = D.argmin(1)
    dist = np.sqrt(D[np.arange(len(fx)), j])
    assert dist.max() < 1e-3                     # locations (px)
    assert np.abs(np.asarray(kps.scale)[v] - okp[j, 2]).max() < 1e-3
    assert np.abs(np.asarray(kps.strength)[v] - okp[j, 3]).max() < 1e-3
    assert (np.asarray(kps.laplace)[v] == okp[j, 4]).all()
    cos = np.sum(np.asarray(d)[v] * od[j], axis=1)
    assert cos.min() > 0.999                     # descriptors
    if check_ori:
        do = np.abs(np.asarray(kps.ori)[v] - okp[j, 6])
        do = np.minimum(do, 2 * np.pi - do)
        assert do.max() < 1e-3
    return okp, od, j


@pytest.mark.slow
def test_upright_golden_pair(left_image, right_image):
    cfg = SurfConfig(max_pts=4096, candidates_per_octave=4096)
    lk, ld, _ = _compare(left_image, _LEFT, cfg)
    rk, rd, _ = _compare(right_image, _RIGHT, cfg)
    assert len(lk) == 2739 and len(rk) == 3443   # reference-true counts
    # matcher semantics on the oracle descriptors reproduce the golden
    # mean score (findMaxCorr, surfd.cu:2610-2669)
    scores = ld @ rd.T
    best = scores.max(axis=1)
    np.testing.assert_allclose(best.mean(), 0.96497, atol=2e-4)


@pytest.mark.slow
def test_extended_golden(left_image):
    cfg = SurfConfig(max_pts=4096, candidates_per_octave=4096,
                     extended=True)
    _compare(left_image, _LEFT, cfg,
             "--extended")


@pytest.mark.slow
def test_rotated_golden(left_image):
    cfg = SurfConfig(max_pts=4096, candidates_per_octave=4096,
                     upright=False)
    _compare(left_image, _LEFT, cfg,
             "--rotated", check_ori=True)
