"""Two-view geometry: batched 8-point essential matrix + RANSAC + pose.

New capability on top of the SURF frontend (BASELINE.json configs 2-3).
RANSAC is reformulated for a data-parallel device: instead of a
sequential hypothesize-and-verify loop, a static batch of H hypotheses
is sampled, solved and scored entirely in parallel (vmap over the
hypothesis axis; the minimal solver is an eigendecomposition of the 9x9
normal matrix, the scoring a dense Sampson-error matrix) -- RANSAC is
embarrassingly parallel and maps onto batched linear algebra.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.precision import f32_matmuls


class TwoViewResult(NamedTuple):
    E: jnp.ndarray          # (3, 3) essential matrix
    R: jnp.ndarray          # (3, 3) rotation cam1 -> cam2
    t: jnp.ndarray          # (3,) unit translation
    inliers: jnp.ndarray    # (K,) bool
    n_inliers: jnp.ndarray  # () int32
    points3d: jnp.ndarray   # (K, 3) triangulated (in cam1 frame)


def _normalize_pts(p, mask):
    """Hartley normalization over masked points: zero mean, mean dist sqrt(2)."""
    wsum = jnp.maximum(mask.sum(), 1.0)
    mean = (p * mask[:, None]).sum(0) / wsum
    d = jnp.sqrt(((p - mean) ** 2).sum(-1))
    scale = jnp.sqrt(2.0) / jnp.maximum((d * mask).sum() / wsum, 1e-12)
    T = jnp.array([[scale, 0, -scale * mean[0]],
                   [0, scale, -scale * mean[1]],
                   [0, 0, 1.0]], p.dtype)
    return (p - mean) * scale, T


def _smallest_eigvec9(M, iters: int = 4):
    """Eigenvector of the smallest eigenvalue of a PSD 9x9 matrix via
    regularized inverse iteration: a few direct 9x9 solves, which vmap
    over hypotheses in place of a batched jnp.linalg.eigh.  Convergence
    ratio is (lam_min+eps)/(lam_2+eps) — one or two steps suffice for
    the near-null systems RANSAC builds."""
    eps = jnp.float32(1e-9) * jnp.trace(M) + jnp.float32(1e-20)
    B = M + eps * jnp.eye(9, dtype=M.dtype)
    # deterministic start with all components populated
    v = jnp.linspace(1.0, 2.0, 9).astype(M.dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = jnp.linalg.solve(B, v)
        return w * jax.lax.rsqrt(jnp.maximum(w @ w, 1e-30))

    return jax.lax.fori_loop(0, iters, body, v)


@f32_matmuls
def _eight_point(x1, x2, mask):
    """Fundamental/essential system from >= 8 normalized-camera
    correspondences: smallest eigenvector of the 9x9 normal matrix.

    NOTE: returns the UNPROJECTED F (not forced to the essential
    manifold) — Sampson scoring works on it directly; callers project
    the final winner once via `project_essential`."""
    p1, T1 = _normalize_pts(x1, mask)
    p2, T2 = _normalize_pts(x2, mask)
    u1, v1 = p1[:, 0], p1[:, 1]
    u2, v2 = p2[:, 0], p2[:, 1]
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                   jnp.ones_like(u1)], -1)
    A = A * mask[:, None]
    F = _smallest_eigvec9(A.T @ A).reshape(3, 3)
    return T2.T @ F @ T1


@f32_matmuls
def project_essential(F):
    """Project onto the essential manifold (singular values 1, 1, 0)."""
    U, s, Vt = jnp.linalg.svd(F)
    return U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], F.dtype)) @ Vt


@f32_matmuls
def sampson_error(E, x1, x2):
    """Squared Sampson distance in normalized coordinates."""
    ones = jnp.ones((*x1.shape[:-1], 1), x1.dtype)
    h1 = jnp.concatenate([x1, ones], -1)
    h2 = jnp.concatenate([x2, ones], -1)
    Ex1 = h1 @ E.T
    Etx2 = h2 @ E
    num = jnp.sum(h2 * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@f32_matmuls
def _sampson_inlier_counts(Es, x1, x2, valid, thresh):
    """Inlier counts for a whole batch of E candidates at once.

    Es (M, 3, 3) -> (M,) int32.  The per-candidate products are two
    (K, 3) @ (3, 3M) matmuls plus elementwise math, in place of a
    vmap-of-small-matmuls formulation that lowers to thousands of tiny
    batched ops; this form is memory-bound (~2 x K x M x 3 floats).
    The threshold test num/max(den, 1e-12) < t is evaluated as
    num < t * max(den, 1e-12) to skip the division."""
    ones = jnp.ones((*x1.shape[:-1], 1), x1.dtype)
    h1 = jnp.concatenate([x1, ones], -1)                    # (K, 3)
    h2 = jnp.concatenate([x2, ones], -1)
    M = Es.shape[0]
    # Ex1[k, m, c] = sum_j E[m, c, j] h1[k, j]
    Ex1 = (h1 @ Es.reshape(M * 3, 3).T).reshape(-1, M, 3)
    # Etx2[k, m, j] = sum_c E[m, c, j] h2[k, c]
    Etx2 = (h2 @ jnp.swapaxes(Es, -1, -2).reshape(M * 3, 3).T
            ).reshape(-1, M, 3)
    num = jnp.sum(h2[:, None, :] * Ex1, -1) ** 2            # (K, M)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    inl = (num < thresh * jnp.maximum(den, 1e-12)) & valid[:, None]
    return inl.sum(0).astype(jnp.int32)


@f32_matmuls
def triangulate(R, t, x1, x2):
    """Batched DLT triangulation for cameras [I|0] and [R|t].

    Inhomogeneous linear system per point: the 4 DLT rows with w=1 give
    A[:, :3] X = -A[:, 3], solved in closed form via the 3x3 normal
    equations (Cramer) — pure elementwise math that batches over K, in
    place of a batched 4x4 eigh.  Returns (K, 3) points in cam1 frame.
    """
    P1 = jnp.concatenate([jnp.eye(3, dtype=R.dtype),
                          jnp.zeros((3, 1), R.dtype)], 1)
    P2 = jnp.concatenate([R, t[:, None]], 1)

    def rows(P, x):
        return jnp.stack([x[..., 0, None] * P[2] - P[0],
                          x[..., 1, None] * P[2] - P[1]], -2)

    A = jnp.concatenate([rows(P1, x1), rows(P2, x2)], -2)  # (K, 4, 4)
    M = jnp.einsum("kij,kil->kjl", A[..., :3], A[..., :3])  # (K, 3, 3)
    b = -jnp.einsum("kij,ki->kj", A[..., :3], A[..., 3])    # (K, 3)

    # Cramer's rule on the symmetric 3x3 normal system
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    # degenerate rays -> arbitrary finite point (rejected by cheirality)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    X = jnp.stack([c00 * b0 + c01 * b1 + c02 * b2,
                   c01 * b0 + c11 * b1 + c12 * b2,
                   c02 * b0 + c12 * b1 + c22 * b2], -1)
    return X * inv_det[..., None]


@f32_matmuls
def recover_pose(E, x1, x2, mask):
    """Decompose E into the 4 (R, t) candidates, pick by cheirality.

    The 4 candidates' triangulations + depth tests run as ONE vmapped
    batch (triangulate is closed-form elementwise math, so batching the
    candidate axis just widens the arrays instead of issuing 4 separate
    op chains — ~4x fewer tiny ops than a Python loop)."""
    U, _, Vt = jnp.linalg.svd(E)
    d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    U = U * d  # ensure proper rotations
    W = jnp.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    tu = U[:, 2]
    Rs = jnp.stack([Ra, Ra, Rb, Rb])                     # (4, 3, 3)
    ts = jnp.stack([tu, -tu, tu, -tu])                   # (4, 3)
    Xs = jax.vmap(triangulate, in_axes=(0, 0, None, None))(Rs, ts, x1, x2)
    z1 = Xs[..., 2]                                      # (4, K)
    z2 = (jnp.einsum("cki,cji->ckj", Xs, Rs) + ts[:, None, :])[..., 2]
    counts = ((z1 > 0) & (z2 > 0) & mask[None, :]).sum(-1)
    best = jnp.argmax(counts)
    return Rs[best], ts[best], Xs[best]


_N_FINALISTS = 32


def _best_finalist(Es, scores, cand_ok, x1, x2, valid, thresh):
    """Project the _N_FINALISTS best-scoring hypotheses onto the
    essential manifold and return the one of least truncated Sampson
    cost.  Slots the solver marked not-ok (placeholders, spurious roots)
    can fill the finalists when few hypotheses are valid; they never
    win while a valid one exists."""
    fin = jax.lax.top_k(scores, min(_N_FINALISTS, scores.shape[0]))[1]
    Ep = jax.vmap(project_essential)(Es[fin])
    fin_err = jax.vmap(sampson_error, in_axes=(0, None, None))(Ep, x1, x2)
    fin_cost = jnp.sum(jnp.where(valid[None, :],
                                 jnp.minimum(fin_err, thresh), 0.0), axis=1)
    fin_cost = jnp.where(cand_ok[fin], fin_cost, jnp.inf)
    return Ep[jnp.argmin(fin_cost)]


@f32_matmuls
def ransac_essential(x1: jnp.ndarray, x2: jnp.ndarray, valid: jnp.ndarray,
                     key: jax.Array, n_hypotheses: int = 512,
                     inlier_thresh: float = 1e-4,
                     solver: str = "8pt") -> TwoViewResult:
    """Parallel-hypothesis RANSAC for E from normalized correspondences.

    x1, x2: (K, 2) normalized camera coordinates; valid: (K,) mask.
    inlier_thresh: squared Sampson distance threshold (normalized coords).
    solver: "8pt" (least-squares minimal fit) or "5pt" (Nister minimal
    solver, geometry/fivepoint.py) — 5pt needs only 5 all-inlier rows
    per sample (P = w^5 vs w^8), markedly stronger at high outlier
    rates; each sample yields up to 10 essential matrices, all scored
    in the same dense pass.
    """
    k = x1.shape[0]
    count = jnp.maximum(valid.sum(), 1)
    # Sample the (raw % count)-th valid row via inverse-CDF binary
    # search on the validity prefix sum: searchsorted(cdf, r+1) is the
    # index of the (r+1)-th valid element — bit-identical to gathering
    # from a valid-first index compaction, without compaction's 3-level
    # gather (the H*n_pts-point binary search is small).
    cdf = jnp.cumsum(valid.astype(jnp.int32))
    n_pts = 8 if solver == "8pt" else 5
    raw = jax.random.randint(key, (n_hypotheses, n_pts), 0,
                             jnp.iinfo(jnp.int32).max)
    tgt = (raw % count) + 1
    sample = jnp.searchsorted(cdf, tgt.reshape(-1)).reshape(tgt.shape)
    sample = sample.astype(jnp.int32)  # (H, n_pts) indices of valid rows

    if solver == "8pt":
        def solve_one(idx):
            m = jnp.ones(8, x1.dtype)
            return _eight_point(x1[idx], x2[idx], m)

        Es = jax.vmap(solve_one)(sample)                   # (H, 3, 3)
        cand_ok = jnp.ones(Es.shape[0], bool)
    else:
        from .fivepoint import five_point
        # gn_iters=4: inside RANSAC the polish only has to keep the
        # consensus ranking honest — the winner's E is re-derived by two
        # guided least-squares refits on its inlier set below, so the
        # full 8-iteration polish buys nothing here (best consensus
        # count identical at 8/4/2/0 iterations).
        Es, cand_ok = five_point(x1[sample], x2[sample],
                                 gn_iters=4)               # (H, C, 3, 3)
        Es = Es.reshape(-1, 3, 3)
        cand_ok = cand_ok.reshape(-1)
    counts = _sampson_inlier_counts(Es, x1, x2, valid, inlier_thresh)
    scores = jnp.where(cand_ok, counts, -1)

    # Guided refits on the consensus set (two rounds of least-squares on
    # inliers, re-scoring after each) — recovers accuracy the minimal
    # fit can't reach in float32.  Every acceptance decision scores the
    # MANIFOLD-PROJECTED candidate: an unprojected F can rack up
    # Sampson support that evaporates when projected (noisy or
    # quasi-planar data moves F far from the essential manifold), and
    # accepting on the unprojected score used to hand recover_pose a
    # geometry 30-60 degrees off.  Hypotheses still score unprojected
    # (in place of a per-hypothesis 3x3 SVD); only the _N_FINALISTS
    # best-scoring hypotheses and the two refits pay the projection.
    # The projected finalists are ranked by their truncated Sampson cost
    # (MSAC: sum of min(err, thresh) over valid matches), not by the
    # unprojected count: with a high inlier ratio many hypotheses tie on
    # that count, and the first of them can be an E far off the manifold
    # whose support collapses when projected (terrain sequence: 119 -> 2
    # inliers in ~3% of runs), or the mirror solution of a weak-parallax
    # pair that explains as many matches with a larger residual
    # (~10 deg rotation / ~90 deg translation-direction error in ~5%).
    E = _best_finalist(Es, scores, cand_ok, x1, x2, valid, inlier_thresh)
    err = sampson_error(E, x1, x2)
    inliers = (err < inlier_thresh) & valid
    n_best = inliers.sum()
    for _ in range(2):
        E_new = project_essential(
            _eight_point(x1, x2, inliers.astype(x1.dtype)))
        err = sampson_error(E_new, x1, x2)
        inl_new = (err < inlier_thresh) & valid
        use = inl_new.sum() >= n_best
        E = jnp.where(use, E_new, E)
        inliers = jnp.where(use, inl_new, inliers)
        n_best = jnp.maximum(inl_new.sum(), n_best)

    R, t, X = recover_pose(E, x1, x2, inliers)
    return TwoViewResult(E=E, R=R, t=t, inliers=inliers,
                         n_inliers=inliers.sum().astype(jnp.int32),
                         points3d=X)


def normalize_with_intrinsics(pts: jnp.ndarray, fx, fy, cx, cy):
    """Pixel -> normalized camera coordinates."""
    return jnp.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], -1)
