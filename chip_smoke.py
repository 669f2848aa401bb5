#!/usr/bin/env python
"""Chip smoke test: the SURF + SLAM main path once on an NVIDIA GPU.

    python chip_smoke.py               # one GPU: phases 1-9 below
    python chip_smoke.py --four-gpus   # four GPUs: the sharded paths only

One process drives the card(s).  Every input is generated from a seed
(slam/sequence.py renderers, ba/synthetic.py); nothing is downloaded.
The reference demo's configuration runs at full width: 1280x960 frames,
4 octaves, threshold 4.0, upright 64-d descriptors, 4096 keypoints.

Phases (one GPU):
  1. device      the JAX backend is the GPU; card name and power limit
  2. oracle      build native/surforacle.cpp with g++
  3. detect      pair detect+describe vs the C++ oracle (exact counts,
                 locations/scales/strengths < 1e-3, Laplacian equal,
                 descriptor cosine > 0.999); rotated, extended and
                 doubled modes on one frame (orientation < 1e-3 rad)
  4. match       Surf.match vs NumPy float64 D1 @ D2.T
  5. batch       detect_and_compute_batch (B=8) vs per-frame detect
  6. track       track_pair pose errors vs the rendered poses
  7. ba          one lm_step on an 8-camera x 512-point noisy window
  8. slam        12-frame terrain run_sequence ATE
  9. timings     steady-state times, device busy time, memory, compile

Any failed check raises; the process then exits nonzero without the
final line.  The last line of a passing run is the JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
T0 = time.perf_counter()


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, **kw):
    kw["elapsed_s"] = time.perf_counter() - T0
    print(f"{phase}: " + json.dumps(kw, default=float), flush=True)


# ------------------------------------------------------------ comparisons

def oracle_parity(kps, desc, okp, od, check_ori=False):
    """Pipeline keypoints/descriptors vs the C++ oracle's, paired by
    nearest location (tests/test_reference_oracle.py tolerances).
    `kps` fields and `desc` are host arrays; returns the worst errors."""
    import numpy as np
    v = np.asarray(kps.valid)
    n = int(kps.count)
    check(n == len(okp), f"keypoint count {n} != oracle {len(okp)}")
    check(n < v.shape[0], f"keypoint capacity {v.shape[0]} saturated")
    fx, fy = np.asarray(kps.x)[v], np.asarray(kps.y)[v]
    d2 = ((fx[:, None] - okp[None, :, 0]) ** 2
          + (fy[:, None] - okp[None, :, 1]) ** 2)
    j = d2.argmin(1)
    out = dict(
        count=n,
        max_loc_px=float(np.sqrt(d2[np.arange(n), j]).max(initial=0)),
        max_scale=float(np.abs(np.asarray(kps.scale)[v] - okp[j, 2])
                        .max(initial=0)),
        max_strength=float(np.abs(np.asarray(kps.strength)[v] - okp[j, 3])
                           .max(initial=0)),
        laplace_equal=bool((np.asarray(kps.laplace)[v] == okp[j, 4]).all()),
        min_cos=float(np.sum(np.asarray(desc)[v] * od[j], axis=1)
                      .min(initial=1)))
    check(len(set(j.tolist())) == n, "keypoints pair to one oracle point")
    check(out["max_loc_px"] < 1e-3, f"locations {out['max_loc_px']}")
    check(out["max_scale"] < 1e-3, f"scales {out['max_scale']}")
    check(out["max_strength"] < 1e-3, f"strengths {out['max_strength']}")
    check(out["laplace_equal"], "Laplacian signs differ")
    check(out["min_cos"] > 0.999, f"descriptor cosine {out['min_cos']}")
    if check_ori:
        do = np.abs(np.asarray(kps.ori)[v] - okp[j, 6])
        do = np.minimum(do, 2 * np.pi - do)
        out["max_ori_rad"] = float(do.max(initial=0))
        check(out["max_ori_rad"] < 1e-3, f"orientations {out['max_ori_rad']}")
    return out


def match_parity(m, desc1, valid1, desc2, valid2, tol=1e-5):
    """Matches vs NumPy float64 scores over the valid rows/columns: score
    within `tol`; index identical wherever best - second > `tol`."""
    import numpy as np
    v1, v2 = np.asarray(valid1), np.asarray(valid2)
    cols = np.nonzero(v2)[0]
    check(len(cols) > 1, "fewer than two valid set-2 descriptors")
    s = (np.asarray(desc1, np.float64)[v1]
         @ np.asarray(desc2, np.float64)[cols].T)
    order = np.argsort(-s, axis=1, kind="stable")
    rows = np.arange(s.shape[0])
    best, second = s[rows, order[:, 0]], s[rows, order[:, 1]]
    score = np.asarray(m.score)[v1]
    index = np.asarray(m.index)[v1]
    sure = best - second > tol
    out = dict(rows=int(v1.sum()), max_score_err=float(
        np.abs(score - best).max(initial=0)),
        sure_rows=int(sure.sum()),
        index_mismatch=int((index[sure] != cols[order[sure, 0]]).sum()),
        max_ambiguity_err=float(np.abs(
            np.asarray(m.ambiguity)[v1] - second / (best + 1e-6))
            .max(initial=0)))
    check(out["max_score_err"] <= tol, f"scores {out['max_score_err']}")
    check(out["index_mismatch"] == 0,
          f"{out['index_mismatch']} best indices differ")
    check(out["max_ambiguity_err"] <= 1e-4,
          f"ambiguity {out['max_ambiguity_err']}")
    return out


def batch_parity(kb, db, singles, atol=1e-6):
    """Batched keypoints/descriptors vs per-frame (kps, desc) pairs."""
    import numpy as np
    out = dict(frames=len(singles), counts=[], max_desc_err=0.0,
               max_xy_err=0.0)
    for i, (k1, d1) in enumerate(singles):
        n = int(k1.count)
        check(n == int(kb.count[i]), f"frame {i}: count {int(kb.count[i])}"
              f" != single-frame {n}")
        out["counts"].append(n)
        out["max_desc_err"] = max(out["max_desc_err"], float(
            np.abs(np.asarray(d1) - np.asarray(db[i])).max()))
        for f in ("x", "y"):
            out["max_xy_err"] = max(out["max_xy_err"], float(np.abs(
                np.asarray(getattr(k1, f))[:n]
                - np.asarray(getattr(kb, f)[i])[:n]).max(initial=0)))
    check(out["max_desc_err"] <= atol, f"descriptors {out['max_desc_err']}")
    check(out["max_xy_err"] <= 1e-4, f"locations {out['max_xy_err']}")
    return out


def relative_pose(pose1, pose2):
    """(R, t) of camera 2 in camera 1's frame, from world->cam rotations
    and camera centres: x2 = R x1 + t."""
    import numpy as np
    (R1, c1), (R2, c2) = pose1, pose2
    R = R2 @ R1.T
    t = -R2 @ c2 - R @ (-R1 @ c1)
    return R, t


def pose_errors(R_est, t_est, R_true, t_true):
    """(rotation error, translation-direction error) in degrees."""
    import numpy as np
    dR = np.asarray(R_est, np.float64) @ np.asarray(R_true).T
    rot = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    a = np.asarray(t_est, np.float64)
    b = np.asarray(t_true, np.float64)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(rot), float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def flipped_frames(pair):
    """8 distinct frames from a pair: as rendered, mirrored, flipped and
    rotated by 180 degrees."""
    import numpy as np
    out = []
    for op in (lambda a: a, np.fliplr, np.flipud, lambda a: a[::-1, ::-1]):
        out += [np.ascontiguousarray(op(f)) for f in pair]
    return np.stack(out)


# ----------------------------------------------------------------- phases

@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes: the defaults are the chip run's; tests shrink them."""
    h: int = 960
    w: int = 1280
    max_pts: int = 4096
    slam_frames: int = 12
    slam_hw: tuple = (200, 280)
    iters: int = 20


def demo_config(s: Sizes, **kw):
    from cuda_surf_tpu import SurfConfig
    return SurfConfig(noctaves=4, thresh=4.0, upright=True,
                      max_pts=s.max_pts, candidates_per_octave=s.max_pts,
                      **kw)


def detect_pair(a, b, cfg):
    """The benchmark's unit of work: detect+describe of both frames of a
    pair in one program (the reference demo's loop, main.cpp:241-245)."""
    from cuda_surf_tpu.frontend import detect_and_compute
    return detect_and_compute(a, cfg), detect_and_compute(b, cfg)


def phase_oracle_pair(s: Sizes, frames):
    """Phase 3: both frames (one compiled pair program, kept for the
    timings) and the three other modes vs the oracle."""
    import functools
    import jax
    import jax.numpy as jnp
    from cuda_surf_tpu import Surf
    from cuda_surf_tpu.io import write_pgm
    from cuda_surf_tpu.io.oracle import run_oracle
    os.makedirs(OUT, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        paths.append(os.path.join(OUT, f"frame{i}.pgm"))
        write_pgm(paths[-1], f)
    cfg = demo_config(s)
    a, b = jnp.asarray(frames[0]), jnp.asarray(frames[1])
    t0 = time.perf_counter()
    pair = jax.jit(functools.partial(detect_pair, cfg=cfg)).lower(
        a, b).compile()
    pair_compile_s = time.perf_counter() - t0
    results = pair(a, b)
    flags = ("--octaves", str(cfg.noctaves), "--thresh", str(cfg.thresh),
             "--max-pts", "1000000")
    for i, p in enumerate(paths):
        kps, desc = results[i]
        okp, od = run_oracle(p, *flags)
        log(f"phase 3 detect frame{i}", **oracle_parity(kps, desc, okp, od))
    # capacities: the doubled mode finds ~3.5x the keypoints
    for mode, kw, cap in (("rotated", dict(upright=False), 2),
                          ("extended", dict(extended=True), 2),
                          ("doubled", dict(doubled=True), 4)):
        mcfg = dataclasses.replace(cfg, max_pts=cap * s.max_pts,
                                   candidates_per_octave=cap * s.max_pts,
                                   **kw)
        kps, desc = Surf(mcfg).detect_and_compute(frames[0])
        okp, od = run_oracle(paths[0], f"--{mode}", *flags)
        log(f"phase 3 detect {mode}",
            **oracle_parity(kps, desc, okp, od,
                            check_ori=mode == "rotated"))
    return Surf(cfg), results, (pair, pair_compile_s)


def phase_match(surf, results):
    (k1, d1), (k2, d2) = results
    m = surf.match(k1, d1, k2, d2)
    log("phase 4 match", **match_parity(m, d1, k1.valid, d2, k2.valid))
    return m


def phase_batch(s: Sizes, surf, pair, frames8):
    """Phase 5: the B-frame program vs the per-frame pipeline (the pair
    program on consecutive frames)."""
    import jax
    from cuda_surf_tpu.frontend import detect_and_compute_batch
    cfg = surf.cfg
    fn = jax.jit(lambda ims: detect_and_compute_batch(ims, cfg))
    kb, db = fn(frames8)
    singles = []
    for i in range(0, len(frames8), 2):
        singles += list(pair(frames8[i], frames8[i + 1]))
    log("phase 5 batch", **batch_parity(kb, db, singles))
    return fn


def phase_track(results, poses, intr):
    import jax
    from cuda_surf_tpu.slam import track_pair
    (k1, d1), (k2, d2) = results
    trk = jax.jit(track_pair)
    res = trk(k1, d1, k2, d2, intr, jax.random.PRNGKey(0))
    R_true, t_true = relative_pose(*poses)
    rot, tdir = pose_errors(res.R, res.t, R_true, t_true)
    log("phase 6 track", inliers=int(res.n_inliers), rot_err_deg=rot,
        tdir_err_deg=tdir)
    check(int(res.n_inliers) >= 100, f"{int(res.n_inliers)} inliers")
    check(rot < 2.0, f"rotation error {rot} deg")
    check(tdir < 5.0, f"translation-direction error {tdir} deg")
    return trk


def phase_ba():
    import jax
    import jax.numpy as jnp
    from cuda_surf_tpu.ba import cost, lm_step
    from cuda_surf_tpu.ba.synthetic import window_problem
    prob, init, _ = window_problem()
    nc = init.R.shape[0]
    step = jax.jit(lambda st, p: lm_step(st, p, jnp.float32(1e-3), nc))
    c0 = float(cost(init, prob))
    c1 = float(cost(step(init, prob), prob))
    log("phase 7 ba", cameras=nc, points=int(init.points.shape[0]),
        cost_before=c0, cost_after=c1)
    check(c1 < c0, f"LM step did not lower the cost: {c0} -> {c1}")
    return step, (init, prob)


def phase_slam(s: Sizes):
    from cuda_surf_tpu import SurfConfig
    from cuda_surf_tpu.slam import SlamPipeline, run_sequence
    from cuda_surf_tpu.slam.sequence import render_terrain_sequence
    frames, centres, intr = render_terrain_sequence(
        n_frames=s.slam_frames, h=s.slam_hw[0], w=s.slam_hw[1], seed=0)
    pipe = SlamPipeline(SurfConfig(noctaves=3, thresh=2.0, max_pts=1024,
                                   candidates_per_octave=1024),
                        intrinsics=intr, loop_detect=True, loop_min_gap=6)
    t0 = time.perf_counter()
    res = run_sequence(pipe, frames, gt=centres)
    log("phase 8 slam", frames=len(frames), ate=res.ate,
        min_inliers=int(res.inliers[1:].min()), loops=len(pipe.loops),
        wall_s=time.perf_counter() - t0)
    check(res.ate < 0.06, f"ATE {res.ate}")
    check((res.inliers[1:] > 60).all(), f"inliers {res.inliers}")


def phase_timings(s: Sizes, surf, results, pair, frames, frames8,
                  batch_fn, trk, intr, ba_step, ba_args):
    """Phase 9: steady-state times (host clock around block_until_ready)
    and device busy time (profiler trace) per program."""
    import jax
    import jax.numpy as jnp
    from cuda_surf_tpu.frontend import _detect_frame
    from cuda_surf_tpu.ops.descriptor import describe
    from cuda_surf_tpu.ops.extrema import _candidate_mask
    from cuda_surf_tpu.ops.integral import integral_image
    from cuda_surf_tpu.ops.matcher import match_keypoints
    from cuda_surf_tpu.utils.timing import (device_busy_ms, kernel_count,
                                            memory_summary, steady_ms)
    cfg = surf.cfg
    a, b = jnp.asarray(frames[0]), jnp.asarray(frames[1])
    (k1, d1), (k2, d2) = results

    def pair_match(x, y):
        (ka, da), (kb, db) = detect_pair(x, y, cfg)
        return match_keypoints(ka, da, kb, db).score

    def pyramid_nms(x):
        ii, pyr, sched = _detect_frame(x, cfg)
        return [_candidate_mask(p, sched[o], cfg) for o, p in enumerate(pyr)]

    ii = jax.jit(integral_image)(a)

    def describe_frame(ii_, kp):
        return describe(ii_, cfg, kp.x, kp.y, kp.scale, kp.ori, kp.valid)

    programs = {
        "pair_detect_describe": (pair, (a, b)),
        "pair_detect_describe_match": (pair_match, (a, b)),
        "pyramid_nms": (pyramid_nms, (a,)),
        "describe": (describe_frame, (ii, k1)),
    }
    for name, (fn, args) in programs.items():
        if isinstance(fn, tuple):           # compiled in phase 3
            compiled, compile_s = fn
        else:
            t0 = time.perf_counter()
            compiled = jax.jit(fn).lower(*args).compile()
            compile_s = time.perf_counter() - t0
        ms = steady_ms(compiled, args, s.iters)
        busy, lines = device_busy_ms(os.path.join(OUT, "trace", name),
                                     compiled, args)
        log(f"timing {name}", ms_rounds=ms, device_busy_ms=busy,
            compile_s=compile_s, kernels=kernel_count(compiled),
            memory=memory_summary(compiled), trace_lines=lines[:4])
    n_kp = int(k1.count)
    log("timing describe keypoints", keypoints=n_kp, capacity=cfg.max_pts)

    B = frames8.shape[0]
    ms = steady_ms(batch_fn, (frames8,), max(2, s.iters // 4))
    log("timing batch", B=B, ms_rounds=ms,
        frames_per_s=[B / (m / 1e3) for m in ms])
    log("timing match", ms_rounds=steady_ms(
        surf.match, (k1, d1, k2, d2), s.iters))
    key = jax.random.PRNGKey(0)
    log("timing track", ms_rounds=steady_ms(
        trk, (k1, d1, k2, d2, intr, key), s.iters))
    log("timing ba_step", ms_rounds=steady_ms(ba_step, ba_args, s.iters))
    stats = jax.devices()[0].memory_stats() or {}
    log("timing peak_memory", peak_bytes_in_use=stats.get(
        "peak_bytes_in_use"))


def run_one_gpu(s: Sizes = Sizes()):
    from cuda_surf_tpu.io.oracle import build_oracle
    from cuda_surf_tpu.slam.sequence import render_terrain_pair
    t0 = time.perf_counter()
    log("phase 2 oracle", binary=os.path.relpath(build_oracle(), ROOT))
    frames, poses, intr = render_terrain_pair(h=s.h, w=s.w, seed=0)
    log("inputs", frames=list(frames.shape),
        render_s=time.perf_counter() - t0)
    surf, results, pair = phase_oracle_pair(s, frames)
    phase_match(surf, results)
    frames8 = flipped_frames(frames)
    batch_fn = phase_batch(s, surf, pair[0], frames8)
    trk = phase_track(results, poses, intr)
    ba_step, ba_args = phase_ba()
    phase_slam(s)
    log("phases 2-8", wall_s=time.perf_counter() - t0)
    phase_timings(s, surf, results, pair, frames, frames8, batch_fn, trk,
                  intr, ba_step, ba_args)


def run_four_gpus(devices, s: Sizes = Sizes()):
    """BatchSurf, distributed LM and the distributed pose graph over a
    4-device mesh, each against its single-device counterpart."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cuda_surf_tpu import Surf
    from cuda_surf_tpu.ba import make_distributed_lm, run_lm, shard_problem
    from cuda_surf_tpu.ba.synthetic import window_problem
    from cuda_surf_tpu.geometry.pose import exp_so3
    from cuda_surf_tpu.parallel import BatchSurf, make_mesh
    from cuda_surf_tpu.slam.posegraph import (PoseGraph, optimize,
                                              optimize_distributed)
    from cuda_surf_tpu.slam.sequence import render_terrain_pair
    check(len(devices) == 4, f"need 4 devices, have {len(devices)}")
    mesh = make_mesh(devices=devices)

    frames, _, _ = render_terrain_pair(h=s.h, w=s.w, seed=0)
    frames8 = flipped_frames(frames)
    cfg = demo_config(s)
    kb, db = BatchSurf(cfg, mesh=mesh).detect_and_compute(frames8)
    surf = Surf(cfg)
    log("four batchsurf", **batch_parity(
        kb, db, [surf.detect_and_compute(f) for f in frames8]))

    prob, init, _ = window_problem()
    n_iters = 8
    final_1, c_1 = jax.jit(lambda st, p: run_lm(st, p, n_iters=n_iters))(
        init, prob)
    prob_s, init_s = shard_problem(prob, init, mesh)
    final_d, c_d = make_distributed_lm(mesh, n_cameras=8,
                                       n_iters=n_iters)(init_s, prob_s)
    from cuda_surf_tpu.ba import cost
    c0 = float(cost(init, prob))
    dt = float(jnp.abs(final_d.t - final_1.t).max())
    log("four distributed_lm", cost_initial=c0, cost_single=float(c_1),
        cost_distributed=float(c_d), max_t_diff=dt)
    check(float(c_d) < 0.5 * c0, "distributed LM did not lower the cost")
    check(abs(float(c_d) - float(c_1)) <= 1e-2 * float(c_1),
          "distributed and single-device LM costs differ")
    check(dt < 1e-3, f"camera translations differ by {dt}")

    rng = np.random.default_rng(11)
    n = 40
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    Rs = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
                   for a in th])
    ts = np.stack([np.array([10 * np.cos(a), 10 * np.sin(a), 0.0])
                   for a in th])
    li = rng.integers(0, n // 2, 6)
    ei = np.concatenate([np.arange(n - 1), li]).astype(np.int32)
    ej = np.concatenate([np.arange(1, n), li + n // 2]).astype(np.int32)
    rel_R = np.einsum("eji,ejk->eik", Rs[ei], Rs[ej])
    rel_t = np.einsum("eji,ej->ei", Rs[ei], ts[ej] - ts[ei])
    dR = np.asarray(exp_so3(jnp.asarray(rng.normal(0, 2e-3, (n, 3)),
                                        jnp.float32)))
    g = PoseGraph(jnp.asarray(Rs @ dR, jnp.float32),
                  jnp.asarray(ts + rng.normal(0, 0.05, ts.shape),
                              jnp.float32),
                  jnp.asarray(ei), jnp.asarray(ej),
                  jnp.asarray(rel_R, jnp.float32),
                  jnp.asarray(rel_t, jnp.float32),
                  jnp.ones(len(ei), jnp.float32))
    gd, cd = optimize_distributed(g, mesh, n_iters=6)
    gs, cs = jax.jit(lambda g_: optimize(g_, n_iters=6, solver="cg"))(g)
    dt = float(np.abs(np.asarray(gd.t) - np.asarray(gs.t)).max())
    log("four distributed_posegraph", cost_first=float(cd[0]),
        cost_distributed=float(cd[-1]), cost_single=float(cs[-1]),
        max_t_diff=dt)
    check(float(cd[-1]) < float(cd[0]), "pose graph cost did not fall")
    check(dt < 1e-3, f"pose-graph translations differ by {dt}")
    np.testing.assert_allclose(np.asarray(cd), np.asarray(cs), rtol=1e-3,
                               atol=1e-7)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU sharded paths and their "
                    "single-device comparisons")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cuda_surf_tpu.utils.compile_cache import enable_compile_cache
    from cuda_surf_tpu.utils.timing import gpu_name_and_power_limit
    log("phase 1 device", compile_cache=os.path.relpath(
        enable_compile_cache(), ROOT), devices=len(jax.devices()),
        kind=jax.devices()[0].device_kind, jax=jax.__version__)
    print(gpu_name_and_power_limit(), flush=True)
    if args.four_gpus:
        check(len(jax.devices()) >= 4, "--four-gpus needs four GPUs")
        run_four_gpus(jax.devices()[:4])
        count = 4
    else:
        run_one_gpu()
        count = len(jax.devices())
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
