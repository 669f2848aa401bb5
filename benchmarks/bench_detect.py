#!/usr/bin/env python
"""Detect-stage microbenchmark: splits ops/extrema.detect (+ the
makePoint/compact stage) into incremental variants to locate the
absolute cost on hardware: dense fit maps, candidate compaction, walk
gathers, final compaction, Laplacian box sums.  Incremental programs
attribute dispatch overhead to stages, so read the differences with
care; a profiler trace is the reference.

    python benchmarks/bench_detect.py [--iters 50]

One JSON line per variant.
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

from cuda_surf_tpu import SurfConfig
from cuda_surf_tpu.io import read_pgm
from cuda_surf_tpu.frontend import _detect_frame, _make_keypoints
from cuda_surf_tpu.ops.extrema import _candidate_mask, detect, fit_dense
from cuda_surf_tpu.slam.sequence import render_terrain_pair
from cuda_surf_tpu.types import compact


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--image", help="PGM image (default: the seeded "
                    "1280x960 terrain frame)")
    args = ap.parse_args()

    cfg = SurfConfig(noctaves=4, thresh=4.0, upright=True, max_pts=4096,
                     candidates_per_octave=4096)
    img = jnp.asarray(read_pgm(args.image) if args.image
                      else render_terrain_pair()[0][0])
    h, w = img.shape
    sched = cfg.hessian_schedule(h, w)

    def base(im):
        ii, pyr, _ = _detect_frame(im, cfg)
        return ii, pyr, [_candidate_mask(p, sched[o], cfg)
                         for o, p in enumerate(pyr)]

    def plus_fit_maps(im):
        ii, pyr, masks = base(im)
        return ii, [fit_dense(p) for p in pyr], masks

    def plus_mask_compact(im):
        ii, pyr, masks = base(im)
        stens = [fit_dense(p) for p in pyr]
        mask = jnp.concatenate([m.reshape(-1) for m in masks])
        total = mask.shape[0]
        lin0 = jax.lax.broadcasted_iota(jnp.int32, (total, 1), 0)[:, 0]
        count, valid, lin = compact(mask, cfg.max_candidates, lin0)
        return ii, stens, count, lin

    def plus_detect(im):
        ii, pyr, _ = _detect_frame(im, cfg)
        return ii, detect(pyr, sched, cfg)

    def plus_keypoints(im):
        ii, cand = plus_detect(im)
        return _make_keypoints(ii, cand, cfg)

    stages = [("pyramid+masks", base),
              ("+fit_maps", plus_fit_maps),
              ("+mask_compact", plus_mask_compact),
              ("+walk(detect)", plus_detect),
              ("+keypoints", plus_keypoints)]
    prev = 0.0
    for name, fn in stages:
        f = jax.jit(fn)
        r = f(img)
        _ = float(jnp.sum(jax.tree_util.tree_leaves(r)[0].astype(jnp.float32)))
        t0 = time.time()
        for _ in range(args.iters):
            r = f(img)
        _ = float(jnp.sum(jax.tree_util.tree_leaves(r)[0].astype(jnp.float32)))
        ms = (time.time() - t0) / args.iters * 1e3
        print(json.dumps({"metric": "detect_stage_ms", "stage": name,
                          "cumulative_ms": round(ms, 3),
                          "stage_ms": round(ms - prev, 3),
                          "device": {"platform": jax.devices()[0].platform,
                                     "kind": jax.devices()[0].device_kind}}),
              flush=True)
        prev = ms


if __name__ == "__main__":
    main()
