"""Schur-complement bundle adjustment (Levenberg-Marquardt).

New capability (BASELINE.json north star); no reference counterpart.
Design decisions:

 - observations are stored per-point, padded to a static max observations
   per point (M), so every array is static-shape and the point (V) blocks
   reduce with plain sums;
 - Jacobians are closed-form (projection chain rule), not autodiff,
   keeping the per-iteration graph small;
 - the reduced camera system S = U - W V^-1 W^T is accumulated as dense
   (C, 6, C, 6) via scatter-add over the M x M camera-pair products of
   each point -- the analogue of the classic sparse Schur trick, laid out
   as batched 3x3/6x6 matmuls instead of sparse maps;
 - the LM loop is a fixed-iteration masked loop (lax.fori_loop with
   accept/reject damping), jit-compatible.

The camera parameterization is world->cam (R, t); increments are
left-multiplied twists: R <- exp(dphi) R, t <- t + dt.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..geometry.pose import exp_so3, hat
from ..utils.precision import f32_matmuls


class BAProblem(NamedTuple):
    """Static-shape BA problem.

    cam_idx: (P, M) int32 camera index of each observation (0 if masked)
    uv:      (P, M, 2) observed normalized-camera coordinates
    mask:    (P, M) bool observation validity
    """
    cam_idx: jnp.ndarray
    uv: jnp.ndarray
    mask: jnp.ndarray


class BAState(NamedTuple):
    R: jnp.ndarray       # (C, 3, 3)
    t: jnp.ndarray       # (C, 3)
    points: jnp.ndarray  # (P, 3)


@f32_matmuls
def project(R, t, X):
    """World point -> normalized image coords for cameras (.., 3, 3)/(.., 3)."""
    xc = (R @ X[..., None])[..., 0] + t
    return xc[..., :2] / jnp.maximum(xc[..., 2:], 1e-9), xc


@f32_matmuls
def residuals(state: BAState, prob: BAProblem):
    """(P, M, 2) reprojection residuals + cam-frame points."""
    Rc = state.R[prob.cam_idx]          # (P, M, 3, 3)
    tc = state.t[prob.cam_idx]          # (P, M, 3)
    uv_hat, xc = project(Rc, tc, state.points[:, None, :])
    r = (uv_hat - prob.uv) * prob.mask[..., None]
    return r, xc


@f32_matmuls
def cost(state: BAState, prob: BAProblem,
         huber_delta: float | None = None) -> jnp.ndarray:
    r, _ = residuals(state, prob)
    if huber_delta is None:
        return 0.5 * jnp.sum(r * r)
    # Huber on the per-observation residual norm
    n = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-20)
    d = jnp.float32(huber_delta)
    rho = jnp.where(n <= d, 0.5 * n * n, d * (n - 0.5 * d))
    return jnp.sum(rho * prob.mask)


def _jacobians(state: BAState, prob: BAProblem,
               huber_delta: float | None = None):
    """Closed-form Jc (P, M, 2, 6), Jp (P, M, 2, 3), residual (P, M, 2).
    With `huber_delta`, rows are IRLS-scaled by sqrt(min(1, delta/|r|))
    so the normal equations realize the Huber robust kernel."""
    Rc = state.R[prob.cam_idx]
    tc = state.t[prob.cam_idx]
    X = state.points[:, None, :]
    xc = (Rc @ X[..., None])[..., 0] + tc               # (P, M, 3)
    z = jnp.maximum(xc[..., 2], 1e-9)
    inv_z = 1.0 / z
    x, y = xc[..., 0], xc[..., 1]
    # d(projection)/d(cam point): (P, M, 2, 3)
    zero = jnp.zeros_like(inv_z)
    Jpi = jnp.stack([
        jnp.stack([inv_z, zero, -x * inv_z * inv_z], -1),
        jnp.stack([zero, inv_z, -y * inv_z * inv_z], -1),
    ], -2)
    # camera: x_cam = exp(dphi)(R X + t - t) ... left-increment on the
    # rotated point: d x_cam/d dphi = -hat(R X), d x_cam/d dt = I
    RX = xc - tc
    Jc = jnp.concatenate([-Jpi @ hat(RX), Jpi], -1)      # (P, M, 2, 6)
    Jp = Jpi @ Rc                                        # (P, M, 2, 3)
    uv_hat = xc[..., :2] * inv_z[..., None]
    r = (uv_hat - prob.uv)
    m = prob.mask[..., None]
    if huber_delta is not None:
        n = jnp.sqrt(jnp.sum((r * m) ** 2, axis=-1, keepdims=True) + 1e-20)
        sw = jnp.sqrt(jnp.minimum(1.0, jnp.float32(huber_delta) / n))
        r = r * sw
        Jc = Jc * sw[..., None]
        Jp = Jp * sw[..., None]
    return Jc * m[..., None], Jp * m[..., None], r * m


@f32_matmuls
def _schur_system(state: BAState, prob: BAProblem, lam, n_cameras: int,
                  huber_delta: float | None = None):
    """Build the damped reduced camera system (S, b) and the point-solve
    residual pieces (Vinv, Wlist, g_p) for back-substitution."""
    Jc, Jp, r = _jacobians(state, prob, huber_delta)
    P, M = prob.mask.shape
    C = n_cameras

    # Camera diagonal blocks U and rhs g_c, accumulated per observation
    # via one-hot contractions in place of scatter-adds.
    cam_oh = jax.nn.one_hot(prob.cam_idx.reshape(-1), C,
                            dtype=Jc.dtype)              # (P*M, C)
    U_obs = jnp.einsum("pmia,pmib->pmab", Jc, Jc)        # (P, M, 6, 6)
    gc_obs = jnp.einsum("pmia,pmi->pma", Jc, r)
    U = jnp.einsum("nc,nz->cz", cam_oh,
                   U_obs.reshape(-1, 36)).reshape(C, 6, 6)
    g_c = cam_oh.T @ gc_obs.reshape(-1, 6)

    # Point blocks (dense per point, static M).
    V = jnp.einsum("pmia,pmib->pab", Jp, Jp)             # (P, 3, 3)
    g_p = jnp.einsum("pmia,pmi->pa", Jp, r)              # (P, 3)
    V_d = V + lam * _diag_only(V) + 1e-9 * jnp.eye(3)
    Vinv = _sym3_inv(V_d)

    # W blocks and Schur products.
    W = jnp.einsum("pmia,pmib->pmab", Jc, Jp)            # (P, M, 6, 3)
    Y = jnp.einsum("pmab,pbc->pmac", W, Vinv)            # (P, M, 6, 3)
    # S -= Y_m1 W_m2^T for all (m1, m2) pairs of each point.  Instead of
    # materializing the (P, M, M, 6, 6) pair tensor and a (P*M^2, C^2)
    # one-hot (quadratic blowup at dense tracks / many cameras), fold
    # the observation axis into per-point per-CAMERA aggregates first:
    #   A_p[c] = sum_{m: cam=c} Y_m,  B_p[c] = sum_{m: cam=c} W_m
    #   S[c,d] = sum_p A_p[c] B_p[d]^T
    # which is ONE (6C, 3P) @ (3P, 6C) matmul — linear in P*M*C.
    cam_oh_m = cam_oh.reshape(P, M, C)
    A = jnp.einsum("pmc,pmax->pcax", cam_oh_m, Y)        # (P, C, 6, 3)
    B = jnp.einsum("pmc,pmax->pcax", cam_oh_m, W)        # (P, C, 6, 3)
    A2 = A.transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    B2 = B.transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    S = (A2 @ B2.T).reshape(C, 6, C, 6).transpose(0, 2, 1, 3)
    S = U[:, None] * _block_eye(C)[..., None, None] - S
    # rhs: b_c = -g_c + Y g_p  (we solve S dx = -grad)
    Yg = jnp.einsum("pmac,pc->pma", Y, g_p)
    b = -(g_c - cam_oh.T @ Yg.reshape(-1, 6))

    # LM damping + gauge fixing (clamp camera 0).
    Sm = S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
    diag = jnp.diag(Sm)
    Sm = Sm + jnp.diag(lam * diag + 1e-9)
    gauge = jnp.arange(6 * C) < 6
    Sm = jnp.where(gauge[:, None] | gauge[None, :],
                   jnp.where(gauge[:, None] & gauge[None, :] &
                             (jnp.arange(6 * C)[:, None] == jnp.arange(6 * C)[None, :]),
                             1e9, 0.0),
                   Sm)
    bv = b.reshape(-1) * (~gauge)
    return Sm, bv, Vinv, W, g_p


def _diag_only(A):
    return A * jnp.eye(A.shape[-1], dtype=A.dtype)


def _sym3_inv(M):
    """Closed-form cofactor inverse of batched symmetric 3x3 blocks —
    pure elementwise math, in place of a batched jnp.linalg.inv (an LU
    per block)."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    row0 = jnp.stack([c00, c01, c02], -1)
    row1 = jnp.stack([c01, c11, c12], -1)
    row2 = jnp.stack([c02, c12, c22], -1)
    return jnp.stack([row0, row1, row2], -2) * inv_det[..., None, None]


def _block_eye(c):
    return jnp.eye(c)


@f32_matmuls
def lm_step(state: BAState, prob: BAProblem, lam, n_cameras: int,
            huber_delta: float | None = None):
    Sm, bv, Vinv, W, g_p = _schur_system(state, prob, lam, n_cameras,
                                         huber_delta)
    dc = jnp.linalg.solve(Sm, bv).reshape(n_cameras, 6)
    # back-substitute points: dp = -Vinv (g_p + W^T dc); one-hot
    # select instead of a row gather
    P, M = prob.mask.shape
    cam_oh = jax.nn.one_hot(prob.cam_idx.reshape(-1), n_cameras,
                            dtype=dc.dtype)
    dc_obs = (cam_oh @ dc).reshape(P, M, 6)
    Wt_dc = jnp.einsum("pmab,pma->pb", W, dc_obs)        # (P, 3)
    dp = -jnp.einsum("pab,pb->pa", Vinv, g_p + Wt_dc)
    new_R = exp_so3(dc[:, :3]) @ state.R
    new_t = state.t + dc[:, 3:]
    new_points = state.points + dp
    return BAState(new_R, new_t, new_points)


@f32_matmuls
def run_lm(state: BAState, prob: BAProblem, n_iters: int = 10,
           lam0: float = 1e-3, huber_delta: float | None = None):
    """Fixed-iteration LM with accept/reject damping (jit-friendly).
    `huber_delta` enables the Huber robust kernel (IRLS) — use ~1-3
    pixels in normalized units for outlier-contaminated tracks."""
    n_cameras = state.R.shape[0]

    def body(_, carry):
        state, lam, c0 = carry
        cand = lm_step(state, prob, lam, n_cameras, huber_delta)
        c1 = cost(cand, prob, huber_delta)
        ok = (c1 < c0) & jnp.isfinite(c1)
        state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(ok, b, a), state, cand)
        lam = jnp.where(ok, jnp.maximum(lam * 0.3, 1e-9),
                        jnp.minimum(lam * 8.0, 1e6))
        return state, lam, jnp.where(ok, c1, c0)

    c0 = cost(state, prob, huber_delta)
    state, lam, c_final = lax.fori_loop(
        0, n_iters, body, (state, jnp.float32(lam0), c0))
    return state, c_final
