"""End-to-end monocular SLAM accuracy evaluation on the ray-marched
terrain orbit (slam/sequence.py:render_terrain_sequence): VO, loop
closure, SE(3) pose graph and scale-drift-aware Sim(3) pose graph.

This is the accuracy-contract evidence for BASELINE.md ("ATE on
standard sequences"): a ground-truthed, genuinely 3D scene with a
closed-loop trajectory.  Reference has no SLAM backend (SURVEY.md
section 1) — this measures the north-star capability.

Usage:  python benchmarks/eval_terrain.py [--frames 50] [--loop-gap 10]

Recorded result (50 frames, 200x280, seed 0, orbit radius 0.28; ATE
is device-independent up to RANSAC float noise):
    VO ATE                      0.192
    + SE(3) graph               0.118
    + Sim(3) after SE(3)        0.089   <- recommended recipe
    (Sim(3) alone               0.126)
With --window-ba 8 (windowed Schur BA over landmark tracks —
BASELINE config 3):
    VO+BA                       0.167
    + SE(3) graph               0.099
    + Sim(3) after SE(3)        0.060
SE(3) loop edges already carry measured baselines (scale recovered
from the closure's own triangulation), so they fix most positional
scale drift; the Sim(3) pass then redistributes the residual
per-node scale error that SE(3) cannot represent.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cuda_surf_tpu import SurfConfig
from cuda_surf_tpu.slam import SlamPipeline, ate_rmse, run_sequence
from cuda_surf_tpu.slam.sequence import render_terrain_sequence


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--width", type=int, default=280)
    ap.add_argument("--loop-gap", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-ba", type=int, default=0, metavar="W",
                    help="windowed Schur-complement BA over landmark "
                         "tracks (BASELINE config 3: multi-frame SfM)")
    ap.add_argument("--forward", action="store_true",
                    help="forward-motion sequence instead of the orbit")
    ap.add_argument("--plot", metavar="PATH.ppm",
                    help="write a top-down trajectory plot (gt white, "
                         "VO red, SE3+Sim3 blue)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="atomically checkpoint pipeline state while "
                         "running (and resume from it if present) — "
                         "the long-run production path")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--loop-store", type=int, default=None,
                    help="ring-cap on frames retaining full "
                         "loop-verification features")
    ap.add_argument("--cache", default=None, metavar="PATH.npz",
                    help="cache rendered frames (the 400-frame 320x440 "
                         "render is ~14 min of host ray-marching)")
    args = ap.parse_args()

    t0 = time.time()
    cache_ok = False
    if args.cache and os.path.exists(args.cache):
        import numpy as _np
        d = _np.load(args.cache)
        if (d["frames"].shape == (args.frames, args.height, args.width)
                and int(d["seed"]) == args.seed
                and bool(d["forward"]) == args.forward):
            frames, centres = d["frames"], d["centres"]
            from cuda_surf_tpu.slam.tracking import Intrinsics
            intr = Intrinsics(*[float(v) for v in d["intr"]])
            cache_ok = True
            print(f"loaded {args.frames} cached frames")
    if not cache_ok:
        if args.forward:
            from cuda_surf_tpu.slam.sequence import render_forward_sequence
            frames, centres, intr = render_forward_sequence(
                n_frames=args.frames, h=args.height, w=args.width,
                seed=args.seed)
        else:
            frames, centres, intr = render_terrain_sequence(
                n_frames=args.frames, h=args.height, w=args.width,
                seed=args.seed)
        print(f"rendered {args.frames} frames in {time.time() - t0:.0f}s")
        if args.cache:
            import numpy as _np
            _np.savez_compressed(args.cache, frames=frames,
                                 centres=centres, intr=list(intr),
                                 seed=args.seed, forward=args.forward)

    pipe = SlamPipeline(
        SurfConfig(noctaves=3, thresh=2.0, max_pts=1024,
                   candidates_per_octave=1024),
        intrinsics=intr, loop_detect=not args.forward,
        loop_min_gap=args.loop_gap, window_ba=args.window_ba,
        loop_store=args.loop_store)
    t0 = time.time()
    res = run_sequence(pipe, frames, gt=centres,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every)
    dt = time.time() - t0
    print(f"VO+loop-detect: {dt:.0f}s ({1e3 * dt / args.frames:.0f} "
          f"ms/frame incl. detector)  ATE={res.ate:.4f}  "
          f"loops={len(pipe.loops)}")

    vo_frames = [dataclasses.replace(f) for f in pipe.frames]

    cost = pipe.optimize_posegraph()
    ate_se3 = ate_rmse(pipe.trajectory(), centres)
    print(f"SE(3) pose graph:   cost={cost:.3e}  ATE={ate_se3:.4f}")

    cost = pipe.optimize_sim3()
    ate_combo = ate_rmse(pipe.trajectory(), centres)
    print(f"+ Sim(3) pose graph: cost={cost:.3e}  ATE={ate_combo:.4f}")

    if args.plot:
        from cuda_surf_tpu.slam.evaluate import umeyama_align
        from cuda_surf_tpu.viz import plot_trajectories
        from cuda_surf_tpu.io import write_ppm

        def aligned(traj):
            s, R, t = umeyama_align(np.asarray(traj), centres)
            return (s * (R @ np.asarray(traj).T)).T + t

        vo_traj = np.stack([-f.R.T @ f.t for f in vo_frames])
        canvas = plot_trajectories({
            "gt": centres,
            "vo": aligned(vo_traj),
            "se3+sim3": aligned(pipe.trajectory()),
        })
        write_ppm(args.plot, canvas)
        print(f"trajectory plot -> {args.plot}")

    pipe.frames = [dataclasses.replace(f) for f in vo_frames]
    pipe.optimize_sim3()
    ate_sim3 = ate_rmse(pipe.trajectory(), centres)
    print(f"(Sim(3) alone:       ATE={ate_sim3:.4f})")

    print("\nsummary: VO %.4f -> SE3 %.4f -> SE3+Sim3 %.4f "
          "(Sim3 alone %.4f; radius 0.28)"
          % (res.ate, ate_se3, ate_combo, ate_sim3))


if __name__ == "__main__":
    main()
