"""Pose-graph optimization (Gauss-Newton over SE(3) relative constraints).

New capability (BASELINE.json north star).  Per-edge residual
Jacobians come from vmapped forward-mode autodiff; the normal equations
are assembled block-sparse.  Two solve paths, switched on graph size:

 - small graphs (n <= 64 by default): dense (6n, 6n) system assembled
   with one-hot contractions in place of scatter-adds, and one dense
   factorization;
 - large graphs (KITTI-length trajectories, n ~ 1000+): the Hessian is
   never materialized — a matrix-free block-Jacobi-preconditioned
   conjugate-gradient solve whose matvec gathers the two endpoint
   states of every edge and segment-sums the 6x6 block products back,
   O(E) memory instead of the O(E n^2) one-hot / O(n^2) dense system.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..geometry.pose import exp_so3, log_so3, compose, invert
from ..utils.precision import f32_matmuls

# Dense one-hot assembly below this node count, matrix-free CG above.
_DENSE_MAX_NODES = 64


class PoseGraph(NamedTuple):
    R: jnp.ndarray        # (N, 3, 3) world->cam (or cam->world, consistent)
    t: jnp.ndarray        # (N, 3)
    edge_i: jnp.ndarray   # (E,) int32
    edge_j: jnp.ndarray   # (E,) int32
    rel_R: jnp.ndarray    # (E, 3, 3) measured T_i^-1 T_j rotation
    rel_t: jnp.ndarray    # (E, 3)
    weight: jnp.ndarray   # (E,) f32


def _edge_residual(Ri, ti, Rj, tj, rel_R, rel_t, xi_i, xi_j):
    """Residual of one edge with local increments xi (6,) applied:
    r = log( rel^{-1} * (T_i ⊞ xi_i)^{-1} (T_j ⊞ xi_j) )."""
    Ri = exp_so3(xi_i[:3]) @ Ri
    ti = ti + xi_i[3:]
    Rj = exp_so3(xi_j[:3]) @ Rj
    tj = tj + xi_j[3:]
    Rinv, tinv = invert(Ri, ti)
    Rij, tij = compose(Rinv, tinv, Rj, tj)
    Rrel_inv, trel_inv = invert(rel_R, rel_t)
    Re, te = compose(Rrel_inv, trel_inv, Rij, tij)
    return jnp.concatenate([log_so3(Re), te])


def _edge_blocks(graph: PoseGraph, R, t):
    """Residuals + weighted per-edge normal-equation blocks.

    -> r (E, 6), Hii/Hjj/Hij (E, 6, 6), bi/bj (E, 6)."""
    zero6 = jnp.zeros(6, jnp.float32)

    def residual_and_jac(Ri, ti, Rj, tj, rel_R, rel_t):
        f = lambda xi, xj: _edge_residual(Ri, ti, Rj, tj, rel_R, rel_t,
                                          xi, xj)
        r = f(zero6, zero6)
        Ji = jax.jacfwd(f, argnums=0)(zero6, zero6)
        Jj = jax.jacfwd(f, argnums=1)(zero6, zero6)
        return r, Ji, Jj

    ii, jj = graph.edge_i, graph.edge_j
    n = R.shape[0]
    if n <= _DENSE_MAX_NODES:
        # one-hot selects instead of row gathers (one small (E, n)
        # matmul per endpoint)
        oh_i = jax.nn.one_hot(ii, n, dtype=jnp.float32)
        oh_j = jax.nn.one_hot(jj, n, dtype=jnp.float32)
        sel = lambda oh, a: (oh @ a.reshape(n, -1)).reshape(
            oh.shape[0], *a.shape[1:])
        Ri, ti, Rj, tj = sel(oh_i, R), oh_i @ t, sel(oh_j, R), oh_j @ t
    else:
        Ri, ti, Rj, tj = R[ii], t[ii], R[jj], t[jj]
    r, Ji, Jj = jax.vmap(residual_and_jac)(
        Ri, ti, Rj, tj, graph.rel_R, graph.rel_t)
    w = graph.weight[:, None, None]
    Hii = w * jnp.einsum("eai,eaj->eij", Ji, Ji)
    Hjj = w * jnp.einsum("eai,eaj->eij", Jj, Jj)
    Hij = w * jnp.einsum("eai,eaj->eij", Ji, Jj)
    wb = graph.weight[:, None]
    bi = -wb * jnp.einsum("eai,ea->ei", Ji, r)
    bj = -wb * jnp.einsum("eai,ea->ei", Jj, r)
    return r, Hii, Hjj, Hij, bi, bj


def _solve_dense(graph, n, damping, Hii, Hjj, Hij, bi, bj):
    """One-hot dense assembly + factorization (small graphs).
    Block dimension d is read off the edge blocks (6 for SE(3),
    7 for the Sim(3) graph in sim3graph.py)."""
    d = Hii.shape[-1]
    ii, jj = graph.edge_i, graph.edge_j
    oh_i = jax.nn.one_hot(ii, n, dtype=jnp.float32)      # (E, n)
    oh_j = jax.nn.one_hot(jj, n, dtype=jnp.float32)
    oh_hh = jax.nn.one_hot(jnp.concatenate([ii * n + ii, jj * n + jj,
                                            ii * n + jj, jj * n + ii]),
                           n * n, dtype=jnp.float32)     # (4E, n^2)
    blocks = jnp.concatenate(
        [Hii, Hjj, Hij, Hij.transpose(0, 2, 1)], axis=0)
    H = jnp.einsum("ec,ez->cz", oh_hh,
                   blocks.reshape(-1, d * d)).reshape(n, n, d, d)
    b = jnp.concatenate([oh_i, oh_j], axis=0).T @ jnp.concatenate(
        [bi, bj], axis=0)
    Hm = H.transpose(0, 2, 1, 3).reshape(d * n, d * n)
    Hm = Hm + damping * jnp.eye(d * n)
    # gauge: clamp node 0
    gauge = jnp.arange(d * n) < d
    Hm = jnp.where(gauge[:, None] | gauge[None, :], 0.0, Hm)
    Hm = Hm + jnp.diag(jnp.where(gauge, 1.0, 0.0))
    bv = b.reshape(-1) * (~gauge)
    return jnp.linalg.solve(Hm, bv).reshape(n, d)


def _solve_cg(graph, n, damping, Hii, Hjj, Hij, bi, bj,
              cg_iters: int, cg_tol: float = 1e-8):
    """Matrix-free block-Jacobi-preconditioned CG (large graphs).

    H is applied edge-wise: gather the endpoint increments, multiply the
    dxd blocks, segment-sum back — O(E) work and memory per matvec."""
    d = Hii.shape[-1]
    ii, jj = graph.edge_i, graph.edge_j
    seg = jnp.concatenate([ii, jj])
    b = jax.ops.segment_sum(jnp.concatenate([bi, bj]), seg, n)
    b = b.at[0].set(0.0)                                  # gauge node 0

    def matvec(x):                                        # x: (n, d)
        xg = x.at[0].set(0.0)
        xi, xj = xg[ii], xg[jj]
        yi = jnp.einsum("eab,eb->ea", Hii, xi) + \
            jnp.einsum("eab,eb->ea", Hij, xj)
        yj = jnp.einsum("eba,eb->ea", Hij, xi) + \
            jnp.einsum("eab,eb->ea", Hjj, xj)
        y = jax.ops.segment_sum(jnp.concatenate([yi, yj]), seg, n)
        y = y + damping * xg
        return y.at[0].set(x[0])                          # identity row 0

    # block-Jacobi preconditioner: inverse of the diagonal dxd blocks
    D = jax.ops.segment_sum(jnp.concatenate([Hii, Hjj]), seg, n)
    D = D + damping * jnp.eye(d) + 1e-9 * jnp.eye(d)
    D = D.at[0].set(jnp.eye(d))
    Dinv = jnp.linalg.inv(D)
    precond = lambda v: jnp.einsum("nab,nb->na", Dinv, v)

    x0 = jnp.zeros_like(b)
    r0 = b                      # b - H @ 0
    z0 = precond(r0)
    bnorm = jnp.sum(b * b)

    def cond(carry):
        k, x, r, z, p, rz = carry
        return (k < cg_iters) & (jnp.sum(r * r) > cg_tol * (bnorm + 1e-30))

    def body(carry):
        k, x, r, z, p, rz = carry
        Hp = matvec(p)
        alpha = rz / (jnp.sum(p * Hp) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / (rz + 1e-30)) * p
        return k + 1, x, r, z, p, rz_new

    _, x, _, _, _, _ = lax.while_loop(
        cond, body, (0, x0, r0, z0, z0, jnp.sum(r0 * z0)))
    return x


def edge_residuals(graph: PoseGraph) -> jnp.ndarray:
    """Unweighted per-edge residuals (E, 6) at the graph's current
    state — the a-posteriori consistency check behind chi-square edge
    rejection (loopclosure.optimize_with_loops)."""
    r, *_ = _edge_blocks(graph, graph.R, graph.t)
    return r


def robust_factors(r, robust_delta, robust_mask):
    """Huber IRLS edge weights: 1 inside `robust_delta`, delta/||r||
    outside — linearizes the loss for gross-residual edges so one bad
    loop closure cannot hijack the solution.  `robust_mask` restricts
    reweighting (loop edges only: odometry residuals near a correction
    are LEGITIMATELY large mid-optimization, and downweighting them
    stalls convergence)."""
    rnorm = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-20)
    f = jnp.minimum(1.0, robust_delta / rnorm)
    if robust_mask is not None:
        f = jnp.where(robust_mask, f, 1.0)
    return f


@f32_matmuls
def optimize(graph: PoseGraph, n_iters: int = 10,
             damping: float = 1e-6, solver: str = "auto",
             cg_iters: int | None = None,
             robust_delta: float | None = None,
             robust_mask: jnp.ndarray | None = None) -> PoseGraph:
    """`solver`: "dense" | "cg" | "auto" (dense up to 64 nodes).
    `robust_delta`: Huber IRLS threshold on the per-edge residual norm
    (None = pure least squares); `robust_mask` (E,) bool restricts the
    reweighting to the marked edges."""
    n = graph.R.shape[0]
    if solver == "auto":
        solver = "dense" if n <= _DENSE_MAX_NODES else "cg"
    if cg_iters is None:
        cg_iters = max(8 * n, 200)

    def step(carry, _):
        R, t = carry
        r, Hii, Hjj, Hij, bi, bj = _edge_blocks(graph, R, t)
        if robust_delta is not None:
            f = robust_factors(r, robust_delta, robust_mask)
            Hii = f[:, None, None] * Hii
            Hjj = f[:, None, None] * Hjj
            Hij = f[:, None, None] * Hij
            bi = f[:, None] * bi
            bj = f[:, None] * bj
        if solver == "dense":
            dx = _solve_dense(graph, n, damping, Hii, Hjj, Hij, bi, bj)
        else:
            dx = _solve_cg(graph, n, damping, Hii, Hjj, Hij, bi, bj,
                           cg_iters)
        R = exp_so3(dx[:, :3]) @ R
        t = t + dx[:, 3:]
        return (R, t), jnp.sum(r * r)

    (R, t), costs = lax.scan(step, (graph.R, graph.t), None, length=n_iters)
    return graph._replace(R=R, t=t), costs


# ----------------------------------------------------- distributed (mesh)

def _pad_graph_edges(graph: PoseGraph, multiple: int):
    """Pad the edge axis to a multiple with zero-weight identity
    self-edges (0, 0, rel=I): their residual is exactly zero and their
    weight zeroes every normal-equation block, so padding is inert."""
    E = int(graph.edge_i.shape[0])
    pad = (-E) % multiple
    if pad == 0:
        return graph
    zi = jnp.zeros(pad, jnp.int32)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=graph.rel_R.dtype),
                           (pad, 3, 3))
    return graph._replace(
        edge_i=jnp.concatenate([graph.edge_i, zi]),
        edge_j=jnp.concatenate([graph.edge_j, zi]),
        rel_R=jnp.concatenate([graph.rel_R, eye]),
        rel_t=jnp.concatenate([graph.rel_t,
                               jnp.zeros((pad, 3), graph.rel_t.dtype)]),
        weight=jnp.concatenate([graph.weight,
                                jnp.zeros(pad, graph.weight.dtype)]))


@f32_matmuls
def optimize_distributed(graph: PoseGraph, mesh, n_iters: int = 10,
                         damping: float = 1e-6,
                         cg_iters: int | None = None,
                         robust_delta: float | None = None,
                         robust_mask: jnp.ndarray | None = None):
    """Pose-graph Gauss-Newton with the EDGE axis sharded over `mesh`.

    Each device linearizes only its edge shard (residual + Jacobian
    blocks) and contributes to the node-indexed normal equations by
    local segment-sum + one `psum` over the mesh axis; the
    block-Jacobi-preconditioned CG then needs exactly one psum of an
    (n, 6) vector per matvec — communication O(n) per CG step,
    independent of the edge count.  Nodes are replicated (a trajectory
    of n poses is 12n floats — tiny); the EDGES carry the O(E) work:
    vmapped forward-mode Jacobians, 6x6 block products.

    Reference baseline: no communication layer at all
    (the reference's cuda_utils.h:41-67); this is SURVEY.md section 2.5
    north-star scaling applied to the SLAM backend.  Semantics match
    :func:`optimize` with solver="cg" (the padding edges are inert).

    Returns (optimized PoseGraph [original edge count], costs (n_iters,)).
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    ndev = int(np.prod(mesh.devices.shape))
    E = int(graph.edge_i.shape[0])
    gp = _pad_graph_edges(graph, ndev)
    rmask = robust_mask
    if robust_delta is not None:
        if rmask is None:
            rmask = jnp.ones(E, bool)
        rmask = jnp.concatenate(
            [rmask, jnp.zeros(gp.edge_i.shape[0] - E, bool)])
    else:
        rmask = jnp.zeros(gp.edge_i.shape[0], bool)

    n = gp.R.shape[0]
    d = 6
    if cg_iters is None:
        cg_iters = max(8 * n, 200)

    eshard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    edges = [jax.device_put(a, eshard) for a in
             (gp.edge_i, gp.edge_j, gp.rel_R, gp.rel_t, gp.weight, rmask)]
    R0 = jax.device_put(gp.R, rep)
    t0 = jax.device_put(gp.t, rep)

    def local_run(R, t, edge_i, edge_j, rel_R, rel_t, weight, rmask_l):
        g = PoseGraph(R, t, edge_i, edge_j, rel_R, rel_t, weight)
        ii, jj = edge_i, edge_j
        seg = jnp.concatenate([ii, jj])

        def step(carry, _):
            R, t = carry
            r, Hii, Hjj, Hij, bi, bj = _edge_blocks(g, R, t)
            if robust_delta is not None:
                f = robust_factors(r, robust_delta, rmask_l)
                Hii = f[:, None, None] * Hii
                Hjj = f[:, None, None] * Hjj
                Hij = f[:, None, None] * Hij
                bi = f[:, None] * bi
                bj = f[:, None] * bj
            b = lax.psum(jax.ops.segment_sum(
                jnp.concatenate([bi, bj]), seg, n), axis)
            b = b.at[0].set(0.0)                      # gauge node 0
            D = lax.psum(jax.ops.segment_sum(
                jnp.concatenate([Hii, Hjj]), seg, n), axis)
            D = D + damping * jnp.eye(d) + 1e-9 * jnp.eye(d)
            D = D.at[0].set(jnp.eye(d))
            Dinv = jnp.linalg.inv(D)
            precond = lambda v: jnp.einsum("nab,nb->na", Dinv, v)

            def matvec(x):
                xg = x.at[0].set(0.0)
                xi, xj = xg[ii], xg[jj]
                yi = jnp.einsum("eab,eb->ea", Hii, xi) + \
                    jnp.einsum("eab,eb->ea", Hij, xj)
                yj = jnp.einsum("eba,eb->ea", Hij, xi) + \
                    jnp.einsum("eab,eb->ea", Hjj, xj)
                y = lax.psum(jax.ops.segment_sum(
                    jnp.concatenate([yi, yj]), seg, n), axis)
                y = y + damping * xg
                return y.at[0].set(x[0])

            x0 = jnp.zeros_like(b)
            z0 = precond(b)
            bnorm = jnp.sum(b * b)

            def cond(c):
                k, x, rr, z, p, rz = c
                return (k < cg_iters) & (jnp.sum(rr * rr)
                                         > 1e-8 * (bnorm + 1e-30))

            def body(c):
                k, x, rr, z, p, rz = c
                Hp = matvec(p)
                alpha = rz / (jnp.sum(p * Hp) + 1e-30)
                x = x + alpha * p
                rr = rr - alpha * Hp
                z = precond(rr)
                rz_new = jnp.sum(rr * z)
                p = z + (rz_new / (rz + 1e-30)) * p
                return k + 1, x, rr, z, p, rz_new

            _, dx, *_ = lax.while_loop(
                cond, body, (0, x0, b, z0, z0, jnp.sum(b * z0)))
            R = exp_so3(dx[:, :3]) @ R
            t = t + dx[:, 3:]
            return (R, t), lax.psum(jnp.sum(r * r), axis)

        (R, t), costs = lax.scan(step, (R, t), None, length=n_iters)
        return R, t, costs

    run = shard_map(
        local_run, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False)
    R, t, costs = jax.jit(run)(R0, t0, *edges)
    out = graph._replace(R=R, t=t)
    return out, costs
