"""Worker process for the 2-process multi-host runtime test.

Launched by tests/test_multihost.py with SURF_COORDINATOR /
SURF_NUM_PROCESSES / SURF_PROCESS_ID set; each process owns 4 virtual
CPU devices, so the global mesh spans 8 devices across 2 processes —
the same code path a 2-host GPU cluster runs over its network."""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import NamedSharding, PartitionSpec as P


def main():
    from cuda_surf_tpu.parallel import (initialize_from_env, global_mesh,
                                        global_batch)
    from cuda_surf_tpu.ba import BAProblem, BAState, make_distributed_lm

    assert initialize_from_env(), "multiprocess env not detected"
    rank = jax.process_index()
    nproc = jax.process_count()
    assert nproc == 2, nproc
    mesh = global_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 8, n_dev

    # --- cross-process psum over the global mesh ------------------------
    local = np.full((4, 16), rank + 1.0, np.float32)   # 4 rows per process
    x = global_batch(local, mesh)

    @jax.jit
    def total(x):
        f = shard_map(lambda v: lax.psum(jnp.sum(v), "frames"),
                      mesh=mesh, in_specs=P("frames"), out_specs=P(),
                      check_vma=False)
        return f(x)

    got = float(total(x))
    want = float((1.0 + 2.0) * 4 * 16)                 # both processes' rows
    assert abs(got - want) < 1e-3, (got, want)

    # --- distributed BA across the process boundary ---------------------
    rng = np.random.default_rng(0)                     # same on both ranks
    n_cam, n_pts = 4, 64
    X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
    Rs = np.tile(np.eye(3), (n_cam, 1, 1)).astype(np.float32)
    ts = np.stack([[0.3 * c, 0.0, 0.0] for c in range(n_cam)]
                  ).astype(np.float32)
    cam_idx = np.tile(np.arange(n_cam), (n_pts, 1)).astype(np.int32)
    xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
    uv = (xc[..., :2] / xc[..., 2:]).astype(np.float32)
    pts0 = (X + 0.01).astype(np.float32)

    half = n_pts // nproc
    lo, hi = rank * half, (rank + 1) * half
    pt_shard = NamedSharding(mesh, P("frames"))
    rep = NamedSharding(mesh, P())

    def shard_rows(arr):
        return jax.make_array_from_process_local_data(
            pt_shard, np.ascontiguousarray(arr[lo:hi]), arr.shape)

    def replicate(arr):
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, rep, lambda idx: arr[idx])

    prob = BAProblem(shard_rows(cam_idx), shard_rows(uv),
                     shard_rows(np.ones((n_pts, n_cam), bool)))
    state = BAState(replicate(Rs), replicate(ts + 0.01), shard_rows(pts0))
    run = make_distributed_lm(mesh, n_cameras=n_cam, n_iters=4)
    final, cost = run(state, prob)
    cost = float(np.asarray(jax.device_get(cost)))
    assert np.isfinite(cost)

    print(f"RANK{rank} OK psum={got} ba_cost={cost:.8f}", flush=True)


if __name__ == "__main__":
    main()
