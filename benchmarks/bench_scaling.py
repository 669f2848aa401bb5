#!/usr/bin/env python
"""Multi-device scaling-efficiency harness (BASELINE.md target: >=0.8
efficiency across devices).

Measures data-parallel frontend throughput (frames/s) and distributed
bundle-adjustment iteration time at 1..N devices of the available mesh.
On a real multi-chip slice this reports true scaling; under
--virtual N it runs on N virtual CPU devices, which validates the
sharded program end to end (collectives, shardings) without real
parallel speedup — use it as the CI mode.

    python benchmarks/bench_scaling.py            # real devices
    python benchmarks/bench_scaling.py --virtual 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N virtual CPU devices")
    ap.add_argument("--frames-per-device", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 640))
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={args.virtual}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import numpy as np
    import jax.numpy as jnp
    from cuda_surf_tpu import SurfConfig
    from cuda_surf_tpu.parallel import BatchSurf, make_mesh
    from cuda_surf_tpu.ba import BAProblem, BAState, make_distributed_lm, shard_problem

    n_all = len(jax.devices())
    h, w = args.hw
    rng = np.random.default_rng(0)
    cfg = SurfConfig(noctaves=3, max_pts=1024, candidates_per_octave=1024)

    sizes = []
    n = 1
    while n <= n_all:
        sizes.append(n)
        n *= 2
    results = []
    for n in sizes:
        mesh = make_mesh(n)
        bs = BatchSurf(cfg, mesh=mesh)
        B = n * args.frames_per_device
        imgs = rng.integers(0, 256, (B, h, w), np.uint8)
        kps, descs = bs.detect_and_compute(imgs)   # compile
        _ = float(jnp.sum(descs))
        t0 = time.time()
        for _ in range(args.iters):
            kps, descs = bs.detect_and_compute(imgs)
        _ = float(jnp.sum(descs))
        dt = (time.time() - t0) / args.iters
        fps = B / dt

        # distributed BA: points sharded over the mesh
        n_cam, n_pts = 8, 512 * n
        X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
        Rs = np.tile(np.eye(3), (n_cam, 1, 1)).astype(np.float32)
        ts = np.stack([np.array([0.3 * c, 0, 0]) for c in range(n_cam)]
                      ).astype(np.float32)
        cam_idx = np.tile(np.arange(n_cam, dtype=np.int32), (n_pts, 1))
        xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
        uv = (xc[..., :2] / xc[..., 2:]).astype(np.float32)
        prob = BAProblem(jnp.asarray(cam_idx), jnp.asarray(uv),
                         jnp.ones((n_pts, n_cam), bool))
        state = BAState(jnp.asarray(Rs), jnp.asarray(ts + 0.01),
                        jnp.asarray(X + 0.01, jnp.float32))
        prob, state = shard_problem(prob, state, mesh)
        run = make_distributed_lm(mesh, n_cameras=n_cam, n_iters=3)
        out, cost = run(state, prob)
        _ = float(cost)
        t0 = time.time()
        for _ in range(args.iters):
            out, cost = run(state, prob)
        _ = float(cost)
        ba_ms = (time.time() - t0) / args.iters * 1e3
        results.append({"devices": n, "frontend_fps": round(fps, 2),
                        "ba_ms_per_call": round(ba_ms, 3),
                        "points": n_pts})

    base = results[0]["frontend_fps"]
    for r in results:
        eff = r["frontend_fps"] / (base * r["devices"]) if base else 0.0
        print(json.dumps({"metric": "scaling", **r,
                          "frontend_efficiency": round(eff, 3),
                          "virtual": bool(args.virtual)}))


if __name__ == "__main__":
    main()
