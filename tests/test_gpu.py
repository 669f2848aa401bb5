"""Checks that need an NVIDIA GPU (the `gpu` fixture skips them
elsewhere): oracle parity and float64 match parity as compiled for the
card.  Run with `JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu`;
chip_smoke.py covers the same ground at full width."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from cuda_surf_tpu import Surf, SurfConfig
from cuda_surf_tpu.io import write_pgm
from cuda_surf_tpu.io.oracle import build_oracle, run_oracle
from cuda_surf_tpu.ops.matcher import match

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode", ["upright", "rotated"])
def test_pipeline_matches_oracle_on_gpu(gpu, small_image, tmp_path, mode):
    build_oracle()
    cfg = SurfConfig(noctaves=3, max_pts=1024, candidates_per_octave=1024,
                     upright=mode == "upright")
    path = str(tmp_path / "img.pgm")
    write_pgm(path, small_image)
    kps, desc = Surf(cfg).detect_and_compute(small_image)
    okp, od = run_oracle(path, "--octaves", "3",
                         *(() if cfg.upright else ("--rotated",)))
    cs.oracle_parity(kps, desc, okp, od, check_ori=not cfg.upright)


def test_match_precision_on_gpu(gpu):
    """A TF32 cross-matrix (~1e-3) would fail the 1e-5 score bound."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(2, 4096, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    v = np.ones(4096, bool)
    m = match(jnp.asarray(d[0]), jnp.asarray(v), jnp.asarray(d[1]),
              jnp.asarray(v), jnp.zeros(4096), jnp.zeros(4096))
    cs.match_parity(m, d[0], v, d[1], v)
