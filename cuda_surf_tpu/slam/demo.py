"""SLAM sequence demo CLI.

Runs the monocular pipeline over an image-sequence directory (frames
streamed through the native prefetching loader) or, with no arguments,
over a synthetic ground-truthed sequence, reporting per-frame metrics,
throughput and ATE.

    python -m cuda_surf_tpu.slam.demo [frame1.pgm frame2.pgm ...] \
        [--window-ba 5] [--ba-refine] [--posegraph] [--metrics out.jsonl]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import SurfConfig
from ..utils.metrics import MetricsLogger
from .pipeline import SlamPipeline
from .sequence import render_plane_sequence, run_sequence
from .evaluate import ate_rmse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("frames", nargs="*",
                    help="image paths (default: synthetic sequence)")
    ap.add_argument("--synthetic-frames", type=int, default=8)
    ap.add_argument("--octaves", type=int, default=3)
    ap.add_argument("--thresh", type=float, default=2.0)
    ap.add_argument("--max-pts", type=int, default=2048)
    ap.add_argument("--fx", type=float, help="focal length (px)")
    ap.add_argument("--window-ba", type=int, default=0)
    ap.add_argument("--ba-refine", action="store_true")
    ap.add_argument("--posegraph", action="store_true")
    ap.add_argument("--metrics", help="write JSONL metrics to this path")
    ap.add_argument("--checkpoint", help="save pipeline state here at end")
    args = ap.parse_args(argv)

    gt = None
    intr = None
    if args.frames:
        frames = args.frames
    else:
        arr, centres, intr = render_plane_sequence(
            n_frames=args.synthetic_frames, h=240, w=320)
        frames, gt = arr, centres
        print(f"synthetic sequence: {len(arr)} frames 320x240 "
              f"(ground truth available)")
    if args.fx is not None and intr is None and not args.frames:
        pass
    metrics = MetricsLogger(echo=False)
    cfg = SurfConfig(noctaves=args.octaves, thresh=args.thresh,
                     max_pts=args.max_pts,
                     candidates_per_octave=args.max_pts)
    pipe = SlamPipeline(cfg, intrinsics=intr, ba_refine=args.ba_refine,
                        window_ba=args.window_ba, metrics=metrics)

    t0 = time.perf_counter()
    res = run_sequence(pipe, frames, gt=gt)
    wall = time.perf_counter() - t0
    n = len(pipe.frames)
    print(f"frames: {n}   wall: {wall:.2f}s "
          f"({n / wall:.2f} fps incl. compile)")
    print(f"mean inliers: {res.inliers[1:].mean():.1f}")
    if res.ate is not None:
        print(f"ATE (Sim3-aligned RMSE): {res.ate:.5f}")
    if args.posegraph:
        cost = pipe.optimize_posegraph()
        print(f"pose-graph residual: {cost:.3e}")
        if gt is not None:
            print(f"ATE after pose graph: "
                  f"{ate_rmse(pipe.trajectory(), np.asarray(gt)):.5f}")
    if args.metrics:
        metrics.dump(args.metrics)
        print(f"wrote {args.metrics}")
    if args.checkpoint:
        from .checkpoint import save_pipeline
        save_pipeline(args.checkpoint, pipe)
        print(f"wrote {args.checkpoint}")


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
