"""Distributed Schur-complement bundle adjustment over a device mesh.

The BASELINE.json north star: the map (points + observations) is
block-partitioned across devices along the point axis; each device
eliminates its local point blocks and accumulates its contribution to the
reduced camera system, which is summed with `psum` over the mesh (XLA
lowers it to an NCCL all-reduce across GPUs); the small dense
camera solve is replicated, and back-substitution for point updates stays
local to each shard.  Communication per LM iteration is exactly one
all-reduce of (6C)^2 + 6C floats — independent of the number of points.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .core import BAProblem, BAState, cost, _schur_system, exp_so3
from ..utils.precision import f32_matmuls


def shard_problem(prob: BAProblem, state: BAState, mesh: Mesh):
    """Place points/observations sharded over the mesh, cameras replicated."""
    axis = mesh.axis_names[0]
    pt = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    prob = BAProblem(
        cam_idx=jax.device_put(prob.cam_idx, pt),
        uv=jax.device_put(prob.uv, pt),
        mask=jax.device_put(prob.mask, pt),
    )
    state = BAState(
        R=jax.device_put(state.R, rep),
        t=jax.device_put(state.t, rep),
        points=jax.device_put(state.points, pt),
    )
    return prob, state


def make_distributed_lm(mesh: Mesh, n_cameras: int, n_iters: int = 10,
                        lam0: float = 1e-3):
    """Build a jitted distributed LM optimizer over `mesh`."""
    axis = mesh.axis_names[0]
    pspec_pt = P(axis)
    pspec_rep = P()

    def local_iteration(state_rep, points, prob, lam):
        """Runs on each shard: local Schur pieces -> psum -> local update."""
        state = BAState(state_rep[0], state_rep[1], points)
        Sm, bv, Vinv, W, g_p = _schur_system(state, prob, lam, n_cameras)
        Sm = lax.psum(Sm, axis)
        bv = lax.psum(bv, axis)
        dc = jnp.linalg.solve(Sm, bv).reshape(n_cameras, 6)
        dc_obs = dc[prob.cam_idx]
        Wt_dc = jnp.einsum("pmab,pma->pb", W, dc_obs)
        dp = -jnp.einsum("pab,pb->pa", Vinv, g_p + Wt_dc)
        new_R = exp_so3(dc[:, :3]) @ state.R
        new_t = state.t + dc[:, 3:]
        new_points = state.points + dp
        cand = BAState(new_R, new_t, new_points)
        c1 = lax.psum(cost(cand, prob), axis)
        return (new_R, new_t), new_points, c1

    sharded_iter = shard_map(
        local_iteration, mesh=mesh,
        in_specs=((pspec_rep, pspec_rep), pspec_pt,
                  BAProblem(pspec_pt, pspec_pt, pspec_pt), pspec_rep),
        out_specs=((pspec_rep, pspec_rep), pspec_pt, pspec_rep),
        check_vma=False)

    def local_cost(state_rep, points, prob):
        state = BAState(state_rep[0], state_rep[1], points)
        return lax.psum(cost(state, prob), axis)

    sharded_cost = shard_map(
        local_cost, mesh=mesh,
        in_specs=((pspec_rep, pspec_rep), pspec_pt,
                  BAProblem(pspec_pt, pspec_pt, pspec_pt)),
        out_specs=pspec_rep, check_vma=False)

    @jax.jit
    @f32_matmuls
    def run(state: BAState, prob: BAProblem):
        c0 = sharded_cost((state.R, state.t), state.points, prob)

        def body(_, carry):
            state, lam, c0 = carry
            (nR, nt), npts, c1 = sharded_iter(
                (state.R, state.t), state.points, prob, lam)
            ok = (c1 < c0) & jnp.isfinite(c1)
            new_state = BAState(
                jnp.where(ok, nR, state.R),
                jnp.where(ok, nt, state.t),
                jnp.where(ok, npts, state.points))
            lam = jnp.where(ok, jnp.maximum(lam * 0.3, 1e-9),
                            jnp.minimum(lam * 8.0, 1e6))
            return new_state, lam, jnp.where(ok, c1, c0)

        state, _, c_final = lax.fori_loop(
            0, n_iters, body, (state, jnp.float32(lam0), c0))
        return state, c_final

    return run
