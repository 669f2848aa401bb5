"""Two-image detect+match demo CLI.

JAX equivalent of the reference demo executable (main.cpp:74-283,
cudaSurfDemo / cudaSurfDemo2): loads a grayscale stereo pair, runs
detect+describe over `--iters` timed repeats and matching over the same
count, prints per-stage averages and writes annotated keypoint / match
images.

    python -m cuda_surf_tpu.demo [left.pgm right.pgm] --iters 100 \
        --out-dir . [--rotated] [--doubled] [--octaves 4] [--thresh 4.0]

With no images it uses the seeded 1280x960 terrain pair
(slam.sequence.render_terrain_pair).
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import Surf, SurfConfig
from .io import imread_gray, write_ppm
from .viz import draw_keypoints, draw_matches


def _load(paths):
    """(images, names): the given files, or the seeded terrain pair."""
    if paths:
        return [imread_gray(p) for p in paths], list(paths)
    from .slam.sequence import render_terrain_pair
    frames = render_terrain_pair()[0]
    return list(frames), ["terrain frame 0", "terrain frame 1"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", nargs="*", help="two grayscale images "
                    "(default: the seeded terrain pair)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--octaves", type=int, default=4)
    ap.add_argument("--thresh", type=float, default=4.0)
    ap.add_argument("--rotated", action="store_true",
                    help="rotation-invariant descriptors (demo default is "
                    "upright, main.cpp:196)")
    ap.add_argument("--doubled", action="store_true")
    ap.add_argument("--extended", action="store_true",
                    help="128-d descriptors")
    ap.add_argument("--max-pts", type=int, default=4096)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--no-images", action="store_true")
    ap.add_argument("--single", action="store_true",
                    help="single-image detect benchmark (the reference's "
                    "cudaSurfDemo, main.cpp:74-160; default iters 1000)")
    args = ap.parse_args(argv)

    if args.single:
        imgs, names = _load(args.images[:1])
        path = names[0]
        img = jnp.asarray(imgs[0])
        cfg = SurfConfig(noctaves=args.octaves, thresh=args.thresh,
                         upright=not args.rotated, doubled=args.doubled,
                         max_pts=args.max_pts,
                         candidates_per_octave=args.max_pts)
        surf = Surf(cfg)
        kps, desc = surf.detect_and_compute(img)
        jax.block_until_ready(desc)
        iters = args.iters if args.iters != 100 else 1000
        t0 = time.perf_counter()
        for _ in range(iters):
            kps, desc = surf.detect_and_compute(img)
        jax.block_until_ready(desc)
        ms = (time.perf_counter() - t0) / iters * 1e3
        print(f"{path}: {int(kps.count)} keypoints, "
              f"{ms:.3f} ms/frame over {iters} iterations")
        return

    if len(args.images) not in (0, 2):
        ap.error("expected exactly two images")
    (img1, img2), paths = _load(args.images)
    print(f"image 1: {paths[0]} {img1.shape[1]}x{img1.shape[0]}")
    print(f"image 2: {paths[1]} {img2.shape[1]}x{img2.shape[0]}")
    print(f"device:  {jax.devices()[0].platform} "
          f"{jax.devices()[0].device_kind}")

    cfg = SurfConfig(noctaves=args.octaves, thresh=args.thresh,
                     upright=not args.rotated, doubled=args.doubled,
                     extended=args.extended, max_pts=args.max_pts,
                     candidates_per_octave=args.max_pts)
    surf = Surf(cfg)
    d1 = jnp.asarray(img1)
    d2 = jnp.asarray(img2)

    # warmup / compile
    t0 = time.perf_counter()
    kp1, desc1 = surf.detect_and_compute(d1)
    kp2, desc2 = surf.detect_and_compute(d2)
    jax.block_until_ready((desc1, desc2))
    n1, n2 = int(kp1.count), int(kp2.count)
    print(f"compile: {time.perf_counter() - t0:.1f}s")
    print(f"keypoints: {n1} / {n2}")

    # the reference's timing protocol (main.cpp:239-259): both images per
    # iteration, matching timed separately
    t0 = time.perf_counter()
    for _ in range(args.iters):
        kp1, desc1 = surf.detect_and_compute(d1)
        kp2, desc2 = surf.detect_and_compute(d2)
    jax.block_until_ready((desc1, desc2))
    detect_ms = (time.perf_counter() - t0) / args.iters * 1e3

    m = surf.match(kp1, desc1, kp2, desc2)
    jax.block_until_ready(m.score)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        m = surf.match(kp1, desc1, kp2, desc2)
    jax.block_until_ready(m.score)
    match_ms = (time.perf_counter() - t0) / args.iters * 1e3

    score = np.asarray(m.score)
    valid = np.asarray(m.valid)
    amb = np.asarray(m.ambiguity)
    good = valid & (amb < 0.95)
    print(f"detect+describe (pair): {detect_ms:.3f} ms "
          f"({detect_ms / 2:.3f} ms/frame)")
    print(f"match:                  {match_ms:.3f} ms")
    print(f"matches: {int(valid.sum())} "
          f"(ratio-test keep {int(good.sum())}, "
          f"mean score {float(score[valid].mean()):.4f})")

    if not args.no_images:
        kp1h = jax.device_get(kp1)
        kp2h = jax.device_get(kp2)
        os.makedirs(args.out_dir, exist_ok=True)
        p1 = os.path.join(args.out_dir, "surf_show1.ppm")
        p2 = os.path.join(args.out_dir, "surf_show2.ppm")
        pm = os.path.join(args.out_dir, "surf_show_matched.ppm")
        write_ppm(p1, draw_keypoints(img1, kp1h))
        write_ppm(p2, draw_keypoints(img2, kp2h))
        write_ppm(pm, draw_matches(img1, kp1h, img2, kp2h,
                                   jax.device_get(m)))
        print(f"wrote {p1}, {p2}, {pm}")


if __name__ == "__main__":
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
