"""chip_smoke.py's comparison helpers and CPU-reachable paths, at tiny
sizes: oracle parity in every mode, match / batch parity, pose errors,
the timing helpers it shares with bench.py (utils/timing.py), and the
4-device path on virtual CPU devices."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from cuda_surf_tpu import Surf, SurfConfig
from cuda_surf_tpu.io import write_pgm
from cuda_surf_tpu.io.oracle import build_oracle, run_oracle
from cuda_surf_tpu.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_without_gpu(tmp_path, where):
    """No accelerator (or no repository beside it): nonzero exit and no
    result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(ROOT, "chip_smoke.py")) as src, \
                open(script, "w") as dst:
            dst.write(src.read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_MODES = {"upright": ({}, ()), "rotated": ({"upright": False}, ("--rotated",)),
          "extended": ({"extended": True}, ("--extended",)),
          "doubled": ({"doubled": True}, ("--doubled",))}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_oracle_parity_helper(small_image, tmp_path, mode):
    kw, flags = _MODES[mode]
    build_oracle()
    cfg = SurfConfig(noctaves=3, max_pts=1024, candidates_per_octave=1024,
                     **kw)
    path = str(tmp_path / "img.pgm")
    write_pgm(path, small_image)
    kps, desc = Surf(cfg).detect_and_compute(small_image)
    okp, od = run_oracle(path, "--octaves", "3", *flags)
    out = cs.oracle_parity(kps, desc, okp, od,
                           check_ori=mode == "rotated")
    assert out["count"] == len(okp) > 3
    # a displaced keypoint is caught
    bad = jax.tree_util.tree_map(lambda a: a, kps)
    bad.x = kps.x.at[0].add(0.01)
    with pytest.raises(cs.SmokeFailure):
        cs.oracle_parity(bad, desc, okp, od)


def _unit(rng, n, d=64):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("corrupt", [False, True])
def test_match_parity_helper(corrupt):
    from cuda_surf_tpu.ops.matcher import match
    rng = np.random.default_rng(1)
    d1, d2 = _unit(rng, 50), _unit(rng, 70)
    v1 = np.ones(50, bool)
    v1[45:] = False
    v2 = np.ones(70, bool)
    v2[:5] = False
    m = match(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
              jnp.asarray(v2), jnp.zeros(70), jnp.zeros(70))
    if corrupt:
        m = m._replace(index=(m.index + 1) % 70)
        with pytest.raises(cs.SmokeFailure):
            cs.match_parity(m, d1, v1, d2, v2)
    else:
        out = cs.match_parity(m, d1, v1, d2, v2)
        assert out["rows"] == 45 and out["index_mismatch"] == 0


def test_batch_parity_helper():
    from cuda_surf_tpu.frontend import detect_and_compute_batch
    from cuda_surf_tpu.slam.sequence import render_terrain_pair
    frames, _, _ = render_terrain_pair(h=96, w=128)
    frames8 = cs.flipped_frames(frames)
    assert frames8.shape == (8, 96, 128)
    assert len({f.tobytes() for f in frames8}) == 8
    cfg = SurfConfig(noctaves=2, thresh=1.0, max_pts=256,
                     candidates_per_octave=256)
    kb, db = jax.jit(lambda x: detect_and_compute_batch(x, cfg))(frames8)
    surf = Surf(cfg)
    singles = [surf.detect_and_compute(f) for f in frames8]
    out = cs.batch_parity(kb, db, singles)
    assert out["frames"] == 8 and min(out["counts"]) > 0
    with pytest.raises(cs.SmokeFailure):
        cs.batch_parity(kb, db, singles[1:] + singles[:1])


def test_relative_pose_and_errors():
    from cuda_surf_tpu.slam.sequence import terrain_orbit_poses
    from cuda_surf_tpu.geometry.pose import exp_so3
    p1, p2 = terrain_orbit_poses(2, loop=False)
    R, t = cs.relative_pose(p1, p2)
    # the relative pose maps camera-1 coordinates of a world point onto
    # its camera-2 coordinates
    X = np.array([0.1, -0.2, 0.3])
    x1 = p1[0] @ (X - p1[1])
    x2 = p2[0] @ (X - p2[1])
    np.testing.assert_allclose(R @ x1 + t, x2, atol=1e-12)
    assert cs.pose_errors(R, 3 * t, R, t) == pytest.approx((0.0, 0.0),
                                                            abs=1e-5)
    dR = np.asarray(exp_so3(jnp.asarray([0.0, 0.0, np.radians(1.0)])))
    rot, tdir = cs.pose_errors(dR @ R, -t, R, t)
    assert rot == pytest.approx(1.0, abs=1e-3) and tdir == pytest.approx(180)


def test_union_length():
    assert timing.union_length([]) == 0
    assert timing.union_length([(5, 9), (0, 2), (1, 3), (8, 12)]) == 10
    assert timing.union_length([(0, 10), (2, 3)]) == 10


def test_steady_ms():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    ms = timing.steady_ms(fn, (jnp.ones(4),), iters=3, rounds=2)
    assert len(ms) == 2 and all(m >= 0 for m in ms)
    assert len(calls) == 1 + 2 * 3          # one warm-up call


def test_kernel_count_and_memory_summary():
    compiled = jax.jit(lambda x: jnp.sin(x) * 2 + jnp.cos(x).sum()).lower(
        jnp.ones((64, 64))).compile()
    k = timing.kernel_count(compiled)
    assert k["fusions"] >= 1 and k["custom_calls"] >= 0
    mem = timing.memory_summary(compiled)
    assert mem["argument_size_in_bytes"] == 64 * 64 * 4


def test_ba_phase():
    step, (init, prob) = cs.phase_ba()
    assert init.R.shape == (8, 3, 3) and prob.uv.shape == (512, 8, 2)


@pytest.mark.cpu_only  # needs the 8-device virtual CPU mesh
def test_four_device_path_on_virtual_devices():
    assert len(jax.devices()) >= 4
    cs.run_four_gpus(jax.devices()[:4],
                     cs.Sizes(h=96, w=128, max_pts=256))
