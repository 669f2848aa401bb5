#!/usr/bin/env python
"""Throughput benchmark: frames/sec/chip for detect+describe(+match).

BASELINE.json's metric is THROUGHPUT ("frames/sec/chip for
detect+describe+match at 1080p"), not single-pair latency: a production
deployment keeps B frames in flight per chip, so fixed dispatch
overhead amortizes and independent frames fill pipeline gaps.  This
harness sweeps the frames-in-flight count B and reports frames/s/chip
plus the effective per-pair time, on the seeded 1280x960 terrain pair
(slam.sequence.render_terrain_pair; the reference demo's frame size,
main.cpp:239-245).

Two batch modes:
  map    — one jitted program runs B frames through lax.map (each frame
           executes the exact single-frame pipeline).  Measures dispatch
           amortization only.
  fused  — detect_and_compute_batch: per-frame pyramids, keypoint
           stages (compaction + walk + makePoint) FRAME-STACKED into
           one union pass, one describe call over a frame-stacked
           integral image.

    python benchmarks/bench_throughput.py [--iters 30] [--bs 1,2,4,8]

Prints one JSON line per (mode, B).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from cuda_surf_tpu import SurfConfig
from cuda_surf_tpu.frontend import detect_and_compute
from cuda_surf_tpu.slam.sequence import render_terrain_pair


def make_batch(pair, B):
    return jnp.asarray(np.stack([pair[i % 2] for i in range(B)]))


def time_loop(fn, x, iters):
    out = fn(x)
    jax.block_until_ready(out)
    best = float("inf")
    n = max(iters // 3, 4)
    for _ in range(3):   # min of 3 rounds
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(x)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--bs", default="1,2,4,8")
    ap.add_argument("--modes", default="map,fused")
    args = ap.parse_args()

    cfg = SurfConfig(noctaves=4, thresh=4.0, upright=True, max_pts=4096,
                     candidates_per_octave=4096)
    dev = {"platform": jax.devices()[0].platform,
           "kind": jax.devices()[0].device_kind}
    pair = render_terrain_pair()[0]
    rows = []
    for mode in args.modes.split(","):
        for B in [int(b) for b in args.bs.split(",")]:
            imgs = make_batch(pair, B)
            if mode == "map":
                @jax.jit
                def fn(ims):
                    kps, descs = jax.lax.map(
                        lambda im: detect_and_compute(im, cfg), ims)
                    return kps, descs
            else:
                from cuda_surf_tpu.frontend import detect_and_compute_batch

                @jax.jit
                def fn(ims):
                    return detect_and_compute_batch(ims, cfg)
            sec = time_loop(fn, imgs, args.iters)
            fps = B / sec
            row = {"metric": "frames_per_sec_chip", "mode": mode, "B": B,
                   "value": round(fps, 2), "unit": "frames/s",
                   "effective_pair_ms": round(2000.0 * sec / B, 3),
                   "iters": args.iters, "device": dev}
            rows.append(row)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
