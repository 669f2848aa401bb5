"""Sim(3) pose-graph optimization: scale-drift-aware loop closure.

Monocular VO accumulates SCALE drift as well as pose drift; an SE(3)
pose graph cannot absorb it (odometry edges pin the drifted relative
translations, loop edges fight the entire chain).  The standard cure
(Strasdat et al., "Scale drift-aware large scale monocular SLAM") is to
optimize over Sim(3): each node carries (s, R, t) with
x_cam = s R x_world + t, odometry edges measure relative scale 1, and
loop edges measure the accumulated relative scale — Gauss-Newton then
distributes the loop's scale discrepancy smoothly around the cycle.

New capability (no reference counterpart; the reference has no SLAM
backend at all, SURVEY.md section 1).  Per-edge 7-dof
residual Jacobians via vmapped forward-mode autodiff; the solvers
(one-hot dense / matrix-free block-Jacobi CG) are shared with the
SE(3) graph in posegraph.py — the block dimension is inferred.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..geometry.pose import exp_so3, log_so3
from ..utils.precision import f32_matmuls
from .posegraph import _DENSE_MAX_NODES, _solve_cg, _solve_dense


class Sim3Graph(NamedTuple):
    s: jnp.ndarray        # (N,) scale, x_cam = s R x_world + t
    R: jnp.ndarray        # (N, 3, 3)
    t: jnp.ndarray        # (N, 3)
    edge_i: jnp.ndarray   # (E,) int32
    edge_j: jnp.ndarray   # (E,) int32
    rel_s: jnp.ndarray    # (E,) measured scale of S_j S_i^-1
    rel_R: jnp.ndarray    # (E, 3, 3) measured rotation cam_i -> cam_j
    rel_t: jnp.ndarray    # (E, 3)
    weight: jnp.ndarray   # (E, 3) per-component (rot, trans, scale)


def _compose(sa, Ra, ta, sb, Rb, tb):
    """(A o B): x -> s_a R_a (s_b R_b x + t_b) + t_a."""
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _inverse(s, R, t):
    return 1.0 / s, R.T, -(R.T @ t) / s


def _edge_residual(si, Ri, ti, sj, Rj, tj, rel_s, rel_R, rel_t,
                   xi_i, xi_j):
    """7-dof residual of one edge with local increments applied.

    Increment chart: s <- s*exp(sigma), R <- exp(phi) R, t <- t + tau
    with xi = (phi, tau, sigma).  r = [log_so3, trans, log-scale] of
    M^-1 (S_j S_i^-1)."""
    si = si * jnp.exp(xi_i[6])
    Ri = exp_so3(xi_i[:3]) @ Ri
    ti = ti + xi_i[3:6]
    sj = sj * jnp.exp(xi_j[6])
    Rj = exp_so3(xi_j[:3]) @ Rj
    tj = tj + xi_j[3:6]
    s_ij, R_ij, t_ij = _compose(sj, Rj, tj, *_inverse(si, Ri, ti))
    se, Re, te = _compose(*_inverse(rel_s, rel_R, rel_t), s_ij, R_ij, t_ij)
    return jnp.concatenate([log_so3(Re), te, jnp.log(se)[None]])


def _edge_blocks(graph: Sim3Graph, s, R, t):
    zero7 = jnp.zeros(7, jnp.float32)

    def rj(si, Ri, ti, sj, Rj, tj, rel_s, rel_R, rel_t, w):
        f = lambda xi, xj: _edge_residual(si, Ri, ti, sj, Rj, tj,
                                          rel_s, rel_R, rel_t, xi, xj)
        r = f(zero7, zero7)
        Ji = jax.jacfwd(f, argnums=0)(zero7, zero7)
        Jj = jax.jacfwd(f, argnums=1)(zero7, zero7)
        # per-component weights: rows (rot, rot, rot, t, t, t, scale)
        wr = jnp.concatenate([jnp.full(3, w[0]), jnp.full(3, w[1]),
                              w[2][None]])
        return r * wr, Ji * wr[:, None], Jj * wr[:, None]

    ii, jj = graph.edge_i, graph.edge_j
    r, Ji, Jj = jax.vmap(rj)(
        s[ii], R[ii], t[ii], s[jj], R[jj], t[jj],
        graph.rel_s, graph.rel_R, graph.rel_t, graph.weight)
    Hii = jnp.einsum("eai,eaj->eij", Ji, Ji)
    Hjj = jnp.einsum("eai,eaj->eij", Jj, Jj)
    Hij = jnp.einsum("eai,eaj->eij", Ji, Jj)
    bi = -jnp.einsum("eai,ea->ei", Ji, r)
    bj = -jnp.einsum("eai,ea->ei", Jj, r)
    return r, Hii, Hjj, Hij, bi, bj


@f32_matmuls
def optimize(graph: Sim3Graph, n_iters: int = 12, damping: float = 1e-6,
             solver: str = "auto", cg_iters: int | None = None,
             robust_delta: float | None = None,
             robust_mask: jnp.ndarray | None = None):
    from .posegraph import robust_factors
    n = graph.R.shape[0]
    if solver == "auto":
        solver = "dense" if n <= _DENSE_MAX_NODES else "cg"
    if cg_iters is None:
        cg_iters = max(8 * n, 200)

    def step(carry, _):
        s, R, t = carry
        r, Hii, Hjj, Hij, bi, bj = _edge_blocks(graph, s, R, t)
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
        t = t + dx[:, 3:6]
        s = s * jnp.exp(dx[:, 6])
        return (s, R, t), jnp.sum(r * r)

    (s, R, t), costs = lax.scan(step, (graph.s, graph.R, graph.t), None,
                                length=n_iters)
    return graph._replace(s=s, R=R, t=t), costs


def centres(graph: Sim3Graph) -> np.ndarray:
    """Camera centres: s R c + t = 0 -> c = -(1/s) R^T t.

    A node whose scale collapsed toward zero (non-converged optimization
    on a degenerate edge set) is clamped rather than emitting inf/nan —
    callers compare ATE, where one meaningless-but-finite centre is
    strictly better than poisoning the whole alignment."""
    s = np.asarray(graph.s)[:, None]
    s = np.where(np.abs(s) > 1e-12, s, 1e-12)
    R = np.asarray(graph.R)
    t = np.asarray(graph.t)
    return -np.einsum("nij,ni->nj", R.transpose(0, 2, 1), t) / s


def optimize_with_loops_sim3(frames, closures, frame_depths,
                             n_iters: int = 12, loop_weight: float = 5.0,
                             min_gap: int = 10, max_rot: float = 0.6,
                             robust_delta: float = 0.1,
                             reject_residual: float | None = 1.0):
    """Build + optimize the Sim(3) graph from a VO chain and detected
    loop closures.

    `frames`: pipeline FrameStates (.R world->cam, .t).  Odometry edges
    measure the chain's relative SE(3) with relative scale 1 (VO's own
    convention); a loop (i, j) measures relative scale
    frame_depths[i]/frame_depths[j] (the same physical scene seen at
    different drifted local scales) and translation b_i * rel_s * t_unit
    with baseline b_i = frame_depths[i]/med_depth recovered from the
    closure's own triangulation.  Loops with rotation wildly
    inconsistent with the chain (> max_rot radians) are dropped
    (scale/translation inconsistency is exactly what Sim(3) corrects,
    so only rotation is gated).

    Returns (s (N,), R (N,3,3), t (N,3), centres (N,3), final_cost).
    """
    n = len(frames)
    Ri = np.stack([f.R for f in frames]).astype(np.float32)
    ti = np.stack([f.t for f in frames]).astype(np.float32)
    edge_i = list(range(n - 1))
    edge_j = list(range(1, n))
    # odometry: M = S_{k+1} S_k^-1 at s=1: (R_{k+1} R_k^T,
    # t_{k+1} - R_{k+1} R_k^T t_k)
    rel_R = [Ri[k + 1] @ Ri[k].T for k in range(n - 1)]
    rel_t = [ti[k + 1] - rel_R[k] @ ti[k] for k in range(n - 1)]
    rel_s = [1.0] * (n - 1)
    weight = [(1.0, 1.0, 1.0)] * (n - 1)

    kept = 0
    for lc in closures:
        if lc.j - lc.i < min_gap:
            continue
        # rotation consistency gate vs the chain estimate
        est_R = Ri[lc.j] @ Ri[lc.i].T
        dR = lc.R.T @ est_R
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        if ang > max_rot:
            continue
        fd_i = float(frame_depths[lc.i]) if lc.i < len(frame_depths) else 0.0
        fd_j = float(frame_depths[lc.j]) if lc.j < len(frame_depths) else 0.0
        if fd_i <= 1e-9 or fd_j <= 1e-9 or lc.med_depth <= 1e-9:
            continue
        # unit_k = physical length of one chain-gauge unit at step k.
        # fd_k = true_depth_k/unit_k; the closure's OWN triangulation
        # gives the same scene in pair units (|t|=1):
        # med_i = true_depth_i/b_phys, med_j = true_depth_j/b_phys.
        # s_m = unit_i/unit_j = (fd_j * med_i) / (fd_i * med_j) —
        # the med_i/med_j factor cancels genuine scene-depth variation
        # between the two viewpoints out of the drift measurement
        # (plain fd_j/fd_i carries that ~5-10% variation as noise).
        med_j = lc.med_depth_j if lc.med_depth_j > 1e-9 else lc.med_depth
        s_m = (fd_j * lc.med_depth) / (fd_i * med_j)
        b_i = fd_i / lc.med_depth  # baseline in frame-i units
        edge_i.append(lc.i)
        edge_j.append(lc.j)
        rel_R.append(lc.R.astype(np.float32))
        rel_t.append((s_m * b_i * lc.t).astype(np.float32))
        rel_s.append(s_m)
        weight.append((loop_weight, loop_weight, loop_weight))
        kept += 1

    def build(ei, ej, rs, rR, rt, w):
        return Sim3Graph(
            s=jnp.ones(n, jnp.float32),
            R=jnp.asarray(Ri), t=jnp.asarray(ti),
            edge_i=jnp.asarray(ei, jnp.int32),
            edge_j=jnp.asarray(ej, jnp.int32),
            rel_s=jnp.asarray(rs, jnp.float32),
            rel_R=jnp.asarray(np.stack(rR), jnp.float32),
            rel_t=jnp.asarray(np.stack(rt), jnp.float32),
            weight=jnp.asarray(w, jnp.float32))

    graph = build(edge_i, edge_j, rel_s, rel_R, rel_t, weight)
    is_loop = jnp.arange(len(edge_i)) >= (n - 1)
    out, costs = optimize(graph, n_iters=n_iters,
                          robust_delta=robust_delta, robust_mask=is_loop)

    # a-posteriori chi-square loop rejection, exactly as in the SE(3)
    # path (loopclosure.optimize_with_loops): Huber bounds but does not
    # remove a gross outlier's influence
    if reject_residual is not None and len(edge_i) > n - 1:
        r, *_ = _edge_blocks(graph._replace(s=out.s, R=out.R, t=out.t),
                             out.s, out.R, out.t)
        rn = np.linalg.norm(np.asarray(r), axis=1)
        # sim3 _edge_blocks returns WEIGHTED residuals: loop rows carry
        # loop_weight, so the threshold scales with it
        keep = ~np.asarray(is_loop) | (rn < reject_residual * loop_weight)
        if not keep.all() and not keep[n - 1:].any():
            return (np.ones(n), Ri.astype(np.float64),
                    ti.astype(np.float64),
                    np.stack([-Ri[k].T @ ti[k] for k in range(n)]), 0.0)
        if not keep.all():
            ki = np.flatnonzero(keep)
            graph = build([edge_i[i] for i in ki], [edge_j[i] for i in ki],
                          [rel_s[i] for i in ki], [rel_R[i] for i in ki],
                          [rel_t[i] for i in ki], [weight[i] for i in ki])
            out, costs = optimize(graph, n_iters=n_iters,
                                  robust_delta=robust_delta,
                                  robust_mask=jnp.asarray(ki >= (n - 1)))
    return (np.asarray(out.s), np.asarray(out.R), np.asarray(out.t),
            centres(out), float(np.asarray(costs)[-1]))
