#!/usr/bin/env python
"""Benchmark: SURF detect+describe on a 1280x960 stereo pair, on a GPU.

Mirrors the reference's benchmark protocol (cudaSurfDemo2 loop,
main.cpp:239-259): both 1280x960 images detected+described per iteration,
timed over back-to-back calls after warmup; matching timed separately.
The reference publishes 6.5 ms per iteration on a GTX 1080
(its README.md:11-13).  The pair is the seeded terrain render of
`slam.sequence.render_terrain_pair` (the same frames as chip_smoke.py).
Every time is `utils.timing.steady_ms`: 3 rounds of ITERS/3 calls, each
round ending in block_until_ready; the headline is the fastest round,
the median is reported beside it.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
Exits nonzero when JAX finds no GPU.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import jax.tree_util as tu

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cuda_surf_tpu import SurfConfig, Surf
from cuda_surf_tpu.ba.core import lm_step
from cuda_surf_tpu.ba.synthetic import window_problem
from cuda_surf_tpu.frontend import detect_and_compute
from cuda_surf_tpu.ops.matcher import match_keypoints
from cuda_surf_tpu.slam import track_pair
from cuda_surf_tpu.slam.sequence import render_terrain_pair
from cuda_surf_tpu.utils.compile_cache import enable_compile_cache
from cuda_surf_tpu.utils.timing import gpu_name_and_power_limit, steady_ms

BASELINE_MS = 6.5   # the reference's own GTX-1080 number
ITERS = int(os.environ.get("SURF_BENCH_ITERS", "100"))


def med(xs):
    return sorted(xs)[len(xs) // 2]


def rounds_ms(fn, args, iters=None):
    return steady_ms(fn, args, max((iters or ITERS) // 3, 1))


def make_pair_fn(cfg):
    @jax.jit
    def detect_pair(a, b):
        kp1, d1 = detect_and_compute(a, cfg)
        kp2, d2 = detect_and_compute(b, cfg)
        return kp1, d1, kp2, d2
    return detect_pair


def main():
    if jax.default_backend() != "gpu":
        print(f"bench.py: needs an NVIDIA GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = gpu_name_and_power_limit().splitlines()[0]
    frames, _, intr = render_terrain_pair()
    limg, rimg = jnp.asarray(frames[0]), jnp.asarray(frames[1])

    # Demo config (main.cpp:187-204); keypoint capacity sized to the demo's
    # actual yield (a few thousand) rounded up -- identical outputs, static
    # shape small enough that the descriptor stage doesn't pay for dead
    # padding.
    cfg = SurfConfig(noctaves=4, thresh=4.0, upright=True, max_pts=4096,
                     candidates_per_octave=4096)
    surf = Surf(cfg)

    # Subpixel-fit backend: dense every-position fit maps vs
    # per-candidate stencil gathers (bit-identical outputs,
    # tests/test_extrema.py parity) have opposite cost profiles, so time
    # both and keep the faster one.
    fit_rounds = {fit: rounds_ms(
        make_pair_fn(dataclasses.replace(cfg, detect_fit=fit)), (limg, rimg))
        for fit in ("dense", "sparse")}
    fit_used = min(fit_rounds, key=lambda f: min(fit_rounds[f]))
    cfg = dataclasses.replace(cfg, detect_fit=fit_used)
    detect_pair = make_pair_fn(cfg)
    detect_rounds = fit_rounds[fit_used]
    kp1, d1, kp2, d2 = detect_pair(limg, rimg)
    n1, n2 = int(kp1.count), int(kp2.count)

    match_rounds = rounds_ms(surf.match, (kp1, d1, kp2, d2))

    # full two-view geometry on top of matching (the BASELINE.json
    # "detect+describe+match+BA" per-frame metric): ratio/Laplacian
    # filtering, RANSAC essential matrix (5-point minimal solver), pose
    # recovery, triangulation.
    key = jax.random.PRNGKey(0)
    trk = jax.jit(track_pair)
    track_args = (kp1, d1, kp2, d2, intr, key)
    track_rounds = rounds_ms(trk, track_args)
    n_inl = int(trk(*track_args).n_inliers)

    # Device-side windowed-BA cost as one jitted number: one
    # Schur-complement LM step on a window-BA-shaped problem, 8 cameras
    # x 512 points (ba/synthetic.py, the problem chip_smoke.py checks).
    prob, state, _ = window_problem()
    nc = state.R.shape[0]
    ba_step = jax.jit(lambda s, p: lm_step(s, p, jnp.float32(1e-3), nc))
    ba_rounds = rounds_ms(ba_step, (state, prob))

    # BASELINE.json's primary metric is THROUGHPUT (frames/sec/chip)
    # for detect+describe+MATCH (the reference demo times both,
    # main.cpp:239-259): B frames in flight through one jitted program
    # (lax.map of the single-frame pipeline), matched as B/2 pairs
    # in-program.
    B = 8
    frames8 = jnp.stack([limg if i % 2 == 0 else rimg for i in range(B)])
    keys8 = jax.random.split(key, B // 2)

    def pairs(kb, db):
        kpl = tu.tree_map(lambda a: a[0::2], kb)
        kpr = tu.tree_map(lambda a: a[1::2], kb)
        return kpl, db[0::2], kpr, db[1::2]

    @jax.jit
    def detect_match_batch(ims):
        kb, db = jax.lax.map(lambda im: detect_and_compute(im, cfg), ims)
        m = jax.lax.map(lambda t: match_keypoints(*t), pairs(kb, db))
        return m.score

    @jax.jit
    def detect_track_batch(ims):
        kb, db = jax.lax.map(lambda im: detect_and_compute(im, cfg), ims)
        kpl, dl, kpr, dr = pairs(kb, db)
        return jax.lax.map(
            lambda t: track_pair(t[0], t[1], t[2], t[3], intr, t[4]).t,
            (kpl, dl, kpr, dr, keys8))

    tp_iters = max(ITERS // 8, 4) * 3
    tp_rounds = rounds_ms(detect_match_batch, (frames8,), tp_iters)
    trk_rounds = rounds_ms(detect_track_batch, (frames8,), tp_iters)

    # secondary metric: the rotation-invariant path (orientation
    # assignment + rotated descriptors), reference demo uses upright
    rot_rounds = rounds_ms(
        make_pair_fn(dataclasses.replace(cfg, upright=False)), (limg, rimg))

    detect_ms = min(detect_rounds)
    print(json.dumps({
        "metric": "surf_detect_describe_pair_ms",
        "value": round(detect_ms, 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / detect_ms, 3),
        "extra": {
            "frames_per_sec_chip": round(B / min(tp_rounds) * 1e3, 2),
            "frames_per_sec_metric": "detect+describe+match",
            "frames_per_sec_chip_median": round(B / med(tp_rounds) * 1e3, 2),
            "frames_per_sec_with_track": round(B / min(trk_rounds) * 1e3, 2),
            "throughput_pair_ms": round(2 * min(tp_rounds) / B, 4),
            "throughput_B": B,
            "match_ms": round(min(match_rounds), 4),
            "match_ms_median": round(med(match_rounds), 4),
            "track_ms": round(min(track_rounds), 4),
            "track_ms_median": round(med(track_rounds), 4),
            "ba_step_ms": round(min(ba_rounds), 4),
            "detect_fit": fit_used,
            "detect_fit_probe_ms": {k: round(min(v), 3)
                                    for k, v in fit_rounds.items()},
            "detect_ms_median": round(med(detect_rounds), 4),
            "ransac_inliers": n_inl,
            "rotated_pair_ms": round(min(rot_rounds), 4),
            "keypoints": [n1, n2],
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "iters": ITERS,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
