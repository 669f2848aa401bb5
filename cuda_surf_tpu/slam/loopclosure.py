"""Loop-closure detection and pose-graph integration.

Completes the SLAM backend (BASELINE.json north star): candidate loop
pairs are scored with the same brute-force matcher as tracking and
verified with RANSAC essential-matrix geometry; accepted closures become
extra pose-graph edges (monocular scale for the loop translation is
approximated from the current trajectory estimate — a pragmatic SE(3)
stand-in for a full Sim(3) graph).

Known limitation (monocular): loop translations are scaled by the
*estimated* baseline, so loop edges constrain rotation and direction
but cannot correct accumulated scale drift; a Sim(3) pose graph is the
planned upgrade.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Keypoints
from .posegraph import PoseGraph, optimize
from .tracking import Intrinsics, track_pair


class LoopClosure(NamedTuple):
    i: int                  # earlier frame index
    j: int                  # later frame index
    R: np.ndarray           # relative rotation cam_i -> cam_j
    t: np.ndarray           # unit-norm relative translation
    n_inliers: int
    med_depth: float        # median inlier depth in cam_i, in the
                            # pair's unit-baseline gauge (scale recovery)
    med_depth_j: float = 0.0  # same points' median depth in cam_j —
                            # the i/j ratio cancels genuine scene-depth
                            # variation out of the Sim(3) relative-scale
                            # measurement (see optimize_with_loops_sim3)


class LoopDetector:
    """Verifies candidate loop pairs with matcher + RANSAC.

    Frames are registered with their (host) keypoints and descriptors;
    `query(j)` checks frame j against frames i <= j - min_gap and
    returns verified closures.

    An appearance prescreen keeps the per-frame cost bounded: each frame
    stores a pooled descriptor signature (L2-normalized sum of its valid
    SURF descriptors — one 64-d vector); a query scores all stored
    signatures with one small host matmul and only the `prescreen_topk`
    most similar candidates (cosine >= `prescreen_min_sim`) run the
    expensive matcher+RANSAC verification.  Full exhaustive verification
    of an F-frame history is O(F) RANSAC dispatches per query; the
    prescreen caps it at `prescreen_topk` regardless of F.
    Set `prescreen_topk=None` to restore exhaustive verification.

    Memory: full features live on the HOST (the device only ever holds
    the <= prescreen_topk candidates currently being verified, uploaded
    on demand — at max_pts=2048 x 64 f32 a frame is ~0.5 MB, so keeping
    the whole history in HBM would cost ~0.5 MB/frame forever).
    `max_store` additionally caps how many frames retain full features
    (ring eviction, oldest first): signatures are kept for ALL frames,
    but loops to evicted frames can no longer be verified.  None
    (default) retains everything.
    """

    def __init__(self, intr: Intrinsics, min_gap: int = 5,
                 min_inliers: int = 60, ratio: float = 0.9, seed: int = 1,
                 prescreen_topk: int | None = 3,
                 prescreen_min_sim: float = 0.5,
                 max_store: int | None = None):
        if max_store is not None and max_store < 1:
            raise ValueError(f"max_store must be >= 1, got {max_store}")
        self.intr = intr
        self.min_gap = min_gap
        self.min_inliers = min_inliers
        self.prescreen_topk = prescreen_topk
        self.prescreen_min_sim = prescreen_min_sim
        self.max_store = max_store
        self.key = jax.random.PRNGKey(seed)
        # host-side store: entry = (Keypoints with numpy leaves, ndarray
        # desc), or None after ring eviction
        self._frames: List[tuple | None] = []
        self._sigs: List[np.ndarray] = []   # (nfeatures,) host signatures
        self.n_verifications = 0            # RANSAC verifications run
        self._track = jax.jit(
            lambda kp1, d1, kp2, d2, intr, key: track_pair(
                kp1, d1, kp2, d2, intr, key, ratio=ratio))

    @staticmethod
    def _signature(kps: Keypoints, desc) -> np.ndarray:
        d = np.asarray(desc, np.float32)
        v = np.asarray(kps.valid, np.float32)
        s = (d * v[:, None]).sum(0)
        n = np.linalg.norm(s)
        return s / n if n > 1e-12 else s

    def add(self, kps: Keypoints, desc) -> int:
        host = (jax.tree_util.tree_map(np.asarray, kps), np.asarray(desc))
        self._frames.append(host)
        self._sigs.append(self._signature(*host))
        if self.max_store is not None:
            live = [f for f, v in enumerate(self._frames) if v is not None]
            for f in live[:max(0, len(live) - self.max_store)]:
                self._frames[f] = None
        return len(self._frames) - 1

    def _candidates(self, j: int) -> List[int]:
        hi = j - self.min_gap + 1
        if hi <= 0:
            return []
        stored = [i for i in range(hi) if self._frames[i] is not None]
        if self.prescreen_topk is None or len(stored) <= self.prescreen_topk:
            return stored
        sims = np.stack([self._sigs[i] for i in stored]) @ self._sigs[j]
        order = np.argsort(-sims)[: self.prescreen_topk]
        return sorted(stored[int(i)] for i in order
                      if sims[i] >= self.prescreen_min_sim)

    def query(self, j: int | None = None) -> List[LoopClosure]:
        if j is None:
            j = len(self._frames) - 1
        if self._frames[j] is None:
            raise ValueError(
                f"frame {j} was evicted by the max_store={self.max_store} "
                "ring cap; query frames before they age out")
        kpj, dj = self._frames[j]
        out = []
        for i in self._candidates(j):
            kpi, di = self._frames[i]
            # deterministic per-pair key: the verdict on a pair (i, j)
            # must not depend on how many other verifications ran
            # before it (prescreen vs exhaustive query order)
            sub = jax.random.fold_in(self.key, i * 100003 + j)
            res = self._track(kpi, di, kpj, dj, self.intr, sub)
            self.n_verifications += 1
            n = int(res.n_inliers)
            if n >= self.min_inliers:
                inl = np.asarray(res.inliers)
                X3 = np.asarray(res.points3d)
                R_l = np.asarray(res.R, np.float64)
                z_i = X3[:, 2]
                z_j = X3 @ R_l[2] + float(res.t[2])
                pos = inl & (z_i > 0) & (z_j > 0)  # cheirality-consistent
                med = float(np.median(z_i[pos])) if pos.any() else 1.0
                med_j = float(np.median(z_j[pos])) if pos.any() else 1.0
                out.append(LoopClosure(
                    i=i, j=j, R=R_l,
                    t=np.asarray(res.t, np.float64), n_inliers=n,
                    med_depth=med, med_depth_j=med_j))
        return out


def optimize_with_loops(frames, closures: List[LoopClosure],
                        n_iters: int = 15, loop_weight: float = 2.0,
                        max_rot: float = 0.6, max_trans: float = 3.0,
                        frame_depths=None, robust_delta: float = 0.1,
                        reject_residual: float | None = 1.0):
    """Pose-graph optimization over a frame chain plus loop edges.

    `frames`: list with .R (world->cam) and .t attributes (the
    pipeline's FrameState).  Loop translation directions are unit-norm
    (monocular); each is scaled to the currently-estimated baseline
    between its endpoints.  Only GROSSLY inconsistent loop edges are
    gated a priori (max_rot radians / max_trans x baseline vs the chain
    estimate): a genuine closure after a long drifted chain is
    *supposed* to disagree with the estimate — that disagreement is the
    signal — so the gates are wide and outlier suppression is left to
    the Huber IRLS reweighting (`robust_delta`) inside the optimizer.

    With `frame_depths` (per-frame median scene depth in the VO's world
    scale, tracked by the pipeline), the loop translation scale is
    recovered from the closure's own triangulated depths — an
    independent measurement that lets loop edges correct accumulated
    scale drift; otherwise the currently-estimated baseline is used
    (rotation-only correction).  Returns (R (N,3,3), t (N,3),
    final_cost).
    """
    n = len(frames)
    Ri = np.stack([f.R for f in frames])
    ti = np.stack([f.t for f in frames])
    edge_i = list(range(n - 1))
    edge_j = list(range(1, n))
    rel_R = list(np.einsum("nij,nik->njk", Ri[:-1], Ri[1:]))
    rel_t = list(np.einsum("nij,ni->nj", Ri[:-1], ti[1:] - ti[:-1]))
    weight = [1.0] * (n - 1)

    centres = np.stack([-Ri[k].T @ ti[k] for k in range(n)])
    for lc in closures:
        # The detector measures T_rel with T_j = T_rel * T_i (camera-j
        # point = R x_i + t); pose-graph edges are T_i^-1 T_j, so map the
        # measurement through the current estimate of T_i.  The unit-norm
        # monocular translation is scaled to the currently-estimated
        # baseline between the endpoints.
        base = np.linalg.norm(centres[lc.j] - centres[lc.i])
        scale = base
        if frame_depths is not None and lc.med_depth > 1e-9:
            # measured scale: the closure pair triangulates its scene at
            # unit baseline; the same scene's depth in world scale is
            # frame_depths[i], so the true baseline is their ratio
            scale = float(frame_depths[lc.i]) / lc.med_depth
        Riw = Ri[lc.i]
        tiw = ti[lc.i]
        e_R = Riw.T @ lc.R @ Riw
        e_t = Riw.T @ (lc.R @ tiw + scale * lc.t - tiw)
        # consistency gate vs the current chain estimate
        est_R = Riw.T @ Ri[lc.j]
        est_t = Riw.T @ (ti[lc.j] - tiw)
        dR = e_R.T @ est_R
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        dt = np.linalg.norm(e_t - est_t)
        if ang > max_rot or dt > max_trans * (base + 1e-6):
            continue
        edge_i.append(lc.i)
        edge_j.append(lc.j)
        rel_R.append(e_R)
        rel_t.append(e_t)
        weight.append(loop_weight)

    def build(ei, ej, rR, rt, w):
        return PoseGraph(
            R=jnp.asarray(Ri, jnp.float32), t=jnp.asarray(ti, jnp.float32),
            edge_i=jnp.asarray(ei, jnp.int32),
            edge_j=jnp.asarray(ej, jnp.int32),
            rel_R=jnp.asarray(np.stack(rR), jnp.float32),
            rel_t=jnp.asarray(np.stack(rt), jnp.float32),
            weight=jnp.asarray(w, jnp.float32))

    graph = build(edge_i, edge_j, rel_R, rel_t, weight)
    is_loop = jnp.arange(len(edge_i)) >= (n - 1)
    out, costs = optimize(graph, n_iters=n_iters,
                          robust_delta=robust_delta, robust_mask=is_loop)

    # A-posteriori chi-square edge rejection: Huber only BOUNDS an
    # outlier's influence, and with a single gauge anchor a bounded
    # force still displaces a long elastic chain by O(length x delta).
    # A loop edge whose residual norm stays large after the robust pass
    # is inconsistent with the rest of the graph — drop it and re-run
    # (the standard two-stage robust pose-graph recipe).
    if reject_residual is not None and len(edge_i) > n - 1:
        from .posegraph import edge_residuals
        r = np.asarray(edge_residuals(
            graph._replace(R=out.R, t=out.t)))
        rn = np.linalg.norm(r, axis=1)
        keep = ~np.asarray(is_loop) | (rn < reject_residual)
        if not keep.all() and not keep[n - 1:].any():
            # every loop edge rejected: the odometry chain alone is
            # exactly satisfiable — return it untouched rather than
            # keeping the outliers' residual influence
            return Ri.astype(np.float64), ti.astype(np.float64), 0.0
        if not keep.all():
            ki = np.flatnonzero(keep)
            graph = build([edge_i[i] for i in ki],
                          [edge_j[i] for i in ki],
                          [rel_R[i] for i in ki],
                          [rel_t[i] for i in ki],
                          [weight[i] for i in ki])
            is_loop2 = jnp.asarray(ki >= (n - 1))
            out, costs = optimize(graph, n_iters=n_iters,
                                  robust_delta=robust_delta,
                                  robust_mask=is_loop2)
    return (np.asarray(out.R), np.asarray(out.t),
            float(np.asarray(costs)[-1]))
