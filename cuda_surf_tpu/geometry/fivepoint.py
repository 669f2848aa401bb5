"""Batched five-point minimal solver for the essential matrix.

New capability (SURVEY.md section 7 phase 7: "batched 5-pt/8-pt").  The
8-point solver needs all-inlier 8-samples inside RANSAC — markedly
weaker than 5-point hypotheses at high outlier rates (P(all-inlier) =
w^5 vs w^8).

Formulation (Nister, "An efficient solution to the five-point relative
pose problem"): the 4-dim nullspace of the 5x9 epipolar system gives
E = x E1 + y E2 + z E3 + E4; det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0
yield 10 cubics in (x, y, z).  Ordering the 20 cubic monomials with the
(x,y)-degree >= 2 block first and Gauss-Jordan-eliminating it leaves
three relations z*row(m) - row(m*z) for m in {x^2, xy, y^2} that are
LINEAR in (x, y) with z-polynomial coefficients: B(z) [x, y, 1]^T = 0.
det B(z) = 0 is a degree-10 univariate polynomial; (x, y) come from
B(z0)'s nullspace (cross product of rows).

Batched root step: all 10 roots of det B at once by Durand-Kerner
simultaneous iteration — elementwise complex arithmetic, batches over
hypotheses, robust to root clusters (JAX has no batched nonsymmetric
eig on accelerators).  Near-real roots are kept; in RANSAC a lost
complex pair is simply two fewer candidates.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Monomial index tables (built once in numpy).
_LIN = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]          # x, y, z, 1
_QUAD = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
         (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# Nister ordering: (x,y)-degree >= 2 monomials first (eliminated block),
# then the x / y / 1 groups in powers of z.
_E10 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (2, 0, 0), (1, 2, 0),
        (1, 1, 1), (1, 1, 0), (0, 3, 0), (0, 2, 1), (0, 2, 0)]
_R10 = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_MON20 = _E10 + _R10
_IDX20 = {m: i for i, m in enumerate(_MON20)}
_IDX10 = {m: i for i, m in enumerate(_QUAD)}
# reduced-row indices of the monomials used to build B(z)
_ROW_X2, _ROW_X2Z = _IDX20[(2, 0, 0)], _IDX20[(2, 0, 1)]
_ROW_XY, _ROW_XYZ = _IDX20[(1, 1, 0)], _IDX20[(1, 1, 1)]
_ROW_Y2, _ROW_Y2Z = _IDX20[(0, 2, 0)], _IDX20[(0, 2, 1)]

_ADD = lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2])

# lin x lin -> quad: index of the monomial sum for each (a, b) pair
_LL = np.array([[_IDX10[_ADD(a, b)] for b in _LIN] for a in _LIN])
# quad x lin -> 20-monomial cubic
_QL = np.array([[_IDX20[_ADD(q, b)] for b in _LIN] for q in _QUAD])


def _lin_mul(p, q):
    """(..., 4) x (..., 4) -> (..., 10) quadratic coefficients."""
    out = [0.0] * 10
    for a in range(4):
        for b in range(4):
            out[_LL[a, b]] = out[_LL[a, b]] + p[..., a] * q[..., b]
    return jnp.stack(out, axis=-1)


def _quad_lin_mul(Q, p):
    """(..., 10) x (..., 4) -> (..., 20) cubic coefficients."""
    out = [0.0] * 20
    for a in range(10):
        for b in range(4):
            out[_QL[a, b]] = out[_QL[a, b]] + Q[..., a] * p[..., b]
    return jnp.stack(out, axis=-1)


def _constraint_matrix(basis):
    """basis: (..., 4, 3, 3) nullspace matrices E1..E4 (E4 = the
    inhomogeneous term).  -> (..., 10, 20) cubic coefficient matrix."""
    # E entries as linear polynomials: (..., 3, 3, 4)
    e = jnp.moveaxis(basis, -3, -1)

    def lm(i, j, k, l):
        return _lin_mul(e[..., i, j, :], e[..., k, l, :])

    rows = []
    # det(E) = 0
    det = (_quad_lin_mul(lm(1, 1, 2, 2) - lm(1, 2, 2, 1), e[..., 0, 0, :])
           - _quad_lin_mul(lm(1, 0, 2, 2) - lm(1, 2, 2, 0), e[..., 0, 1, :])
           + _quad_lin_mul(lm(1, 0, 2, 1) - lm(1, 1, 2, 0), e[..., 0, 2, :]))
    rows.append(det)
    # 2 E E^T E - tr(E E^T) E = 0  (9 equations)
    # G = E E^T (quadratic, symmetric): G[i][k] = sum_j e_ij e_kj
    G = [[sum(lm(i, j, k, j) for j in range(3)) for k in range(3)]
         for i in range(3)]
    trG = G[0][0] + G[1][1] + G[2][2]
    for i in range(3):
        for l in range(3):
            c = sum(_quad_lin_mul(G[i][k], e[..., k, l, :])
                    for k in range(3))
            rows.append(2.0 * c - _quad_lin_mul(trG, e[..., i, l, :]))
    return jnp.stack(rows, axis=-2)        # (..., 10, 20)


def _bz_rows(M):
    """GJ-eliminate the (x,y)-degree>=2 block and build the 3x3
    z-polynomial matrix B(z) with B [x, y, 1]^T = 0.

    Returns (a, b, c): a, b (..., 3, 4) z^3..z^0 coefficients of the x
    and y columns; c (..., 3, 5) z^4..z^0 of the constant column."""
    G = jnp.linalg.solve(M[..., :10], M[..., 10:])   # (..., 10, 10)
    # reduced row: monomial_i + G[i] . R10 = 0
    a_rows, b_rows, c_rows = [], [], []
    for rm, rmz in ((_ROW_X2, _ROW_X2Z), (_ROW_XY, _ROW_XYZ),
                    (_ROW_Y2, _ROW_Y2Z)):
        g = G[..., rm, :]
        h = G[..., rmz, :]
        # equation: z*(m + g.R) - (mz + h.R) = 0 with z*m = mz, so
        # z*(g.R) - h.R = 0.  R groups: x*(z^2,z,1) -> idx 0..2,
        # y*(z^2,z,1) -> 3..5, (z^3,z^2,z,1) -> 6..9.
        a_rows.append(jnp.stack([g[..., 0], g[..., 1] - h[..., 0],
                                 g[..., 2] - h[..., 1], -h[..., 2]], -1))
        b_rows.append(jnp.stack([g[..., 3], g[..., 4] - h[..., 3],
                                 g[..., 5] - h[..., 4], -h[..., 5]], -1))
        c_rows.append(jnp.stack([g[..., 6], g[..., 7] - h[..., 6],
                                 g[..., 8] - h[..., 7],
                                 g[..., 9] - h[..., 8], -h[..., 9]], -1))
    return (jnp.stack(a_rows, -2), jnp.stack(b_rows, -2),
            jnp.stack(c_rows, -2))


def _poly_mul(p, q):
    """(..., P) x (..., Q) -> (..., P+Q-1), coefficients high-to-low."""
    P, Q = p.shape[-1], q.shape[-1]
    out = [0.0] * (P + Q - 1)
    for i in range(P):
        for j in range(Q):
            out[i + j] = out[i + j] + p[..., i] * q[..., j]
    return jnp.stack(out, -1)


def _det_bz(a, b, c):
    """Degree-10 coefficients (z^10..z^0) of det B(z)."""
    def minor(u, v, i, j):
        return (_poly_mul(u[..., i, :], v[..., j, :])
                - _poly_mul(u[..., j, :], v[..., i, :]))

    det = (_poly_mul(a[..., 0, :], minor(b, c, 1, 2))
           - _poly_mul(b[..., 0, :], minor(a, c, 1, 2))
           + _poly_mul(c[..., 0, :], minor(a, b, 1, 2)))
    return det                                        # (..., 11)


def _nullspace4(Q):
    """Basis of the 4-dim nullspace of batched (..., 5, 9) full-rank
    systems via branch-free Gauss-Jordan with column pivoting — pure
    elementwise math plus two tiny matmuls, in place of a batched
    jnp.linalg.qr(mode="complete") (sequential Householder lowering)
    over the 128-hypothesis batch.  The basis is NOT orthonormal; the Nister parametrization
    E = x E1 + y E2 + z E3 + E4 is valid for any nullspace basis
    (degenerate E4-components are covered by the reversed root pass,
    see _roots_dk).  Returns (..., 9, 4)."""
    M = Q.astype(jnp.float32)
    batch = M.shape[:-2]
    avail = jnp.ones(batch + (9,), bool)
    pivs = []
    for i in range(5):
        row = M[..., i, :]                                  # (..., 9)
        a = jnp.where(avail, jnp.abs(row), -1.0)
        p = (a == jnp.max(a, axis=-1, keepdims=True)).astype(M.dtype)
        # break exact-abs ties: keep the first available max column
        p = p * (jnp.cumsum(p, axis=-1) == 1.0)
        v = jnp.sum(row * p, -1, keepdims=True)
        v = jnp.where(jnp.abs(v) < 1e-25, 1e-25, v)
        row = row / v
        coef = jnp.sum(M * p[..., None, :], -1)             # (..., 5)
        ei = jnp.zeros((5,), M.dtype).at[i].set(1.0)
        coef = coef * (1.0 - ei)                            # skip row i
        M = M - coef[..., None] * row[..., None, :]
        # overwrite row i with its normalized form
        M = jnp.where(ei[..., None] > 0, row[..., None, :], M)
        pivs.append(p)
        avail = avail & (p < 0.5)
    P = jnp.stack(pivs, axis=-2)                            # (..., 5, 9)
    F = avail.astype(M.dtype)                               # (..., 9)
    # Nfull[c, f] = F-diag - sum_i P[i, c] * M[i, f], columns masked to
    # F.  Both contractions are against one-hot selectors, so they must
    # run at HIGHEST precision — the default matmul precision would
    # round the selected M entries to bf16 and poison the basis.
    hi = jax.lax.Precision.HIGHEST
    Nfull = (jnp.eye(9, dtype=M.dtype) * F[..., None, :]
             - jnp.einsum("...ic,...if->...cf", P, M,
                          precision=hi) * F[..., None, :])
    # compress the 4 free columns to a static (..., 9, 4) block
    rank = jnp.cumsum(F, axis=-1) - 1.0
    k4 = jnp.arange(4, dtype=M.dtype)
    Sel = (F[..., :, None] * (rank[..., :, None] == k4)).astype(M.dtype)
    return jnp.einsum("...cf,...fk->...ck", Nfull, Sel, precision=hi)


def _dk_pass(c, n, ctype, n_iters):
    """One Durand-Kerner run on a batch of monic polynomials
    (coefficients c (..., n+1) high-to-low, c[..., 0] == 1)."""
    radius = 1.0 + jnp.max(jnp.abs(c[..., 1:]), axis=-1).real

    def horner(z):
        acc = jnp.ones_like(z)
        for k in range(1, n + 1):
            acc = acc * z + c[..., k:k + 1]
        return acc

    k = jnp.arange(n)
    z0 = (0.7 * radius[..., None].astype(ctype)
          * jnp.exp(2j * jnp.pi * (k + 0.37) / n).astype(ctype))

    def body(_, z):
        diff = z[..., :, None] - z[..., None, :]
        diff = diff + jnp.eye(n, dtype=ctype)          # kill the diagonal
        den = jnp.prod(diff, axis=-1)
        den = jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
        step = horner(z) / den
        mag = jnp.abs(step)
        lim = 0.5 * radius[..., None]
        step = jnp.where(mag > lim, step * (lim / mag), step)
        return z - step

    return jax.lax.fori_loop(0, n_iters, body, z0)


def _roots_dk(coeffs, n_iters: int = 96):
    """Real roots of batched degree-n polynomials via Durand-Kerner
    simultaneous iteration, run on BOTH p(z) and its reversal
    w^n p(1/w).  coeffs (..., n+1) high-to-low.  Returns
    (real_parts (..., 2n), near_real (..., 2n)) — 2n candidates, union
    of the two passes.

    Why two passes: when the leading coefficient is tiny relative to
    the rest (degree collapse — e.g. the solution has a small E3
    component), the monic form's Cauchy radius explodes (~|c_k/c_0|)
    and the iteration strands far from the finite roots.  The reversed
    polynomial maps those roots to 1/z with an O(1) radius and
    converges cleanly; symmetrically, the forward pass covers
    constant-term collapse (roots near 0).  A candidate that is
    garbage in one pass is a converged root in the other; RANSAC
    scoring discards the losers."""
    n = coeffs.shape[-1] - 1
    ctype = jnp.complex64 if coeffs.dtype == jnp.float32 else jnp.complex128
    mag = jnp.max(jnp.abs(coeffs), axis=-1, keepdims=True)
    cs = coeffs / jnp.maximum(mag, 1e-30)

    def monic(c):
        lead = c[..., 0:1]
        lead = jnp.where(jnp.abs(lead) < 1e-20, 1e-20, lead)
        return (c / lead).astype(ctype)

    # one merged run on the stacked [forward; reversed] batch: halves
    # the sequential iteration count vs two passes (the loop body is
    # dispatch-bound at these tiny shapes, so wall time ~ iterations)
    both = jnp.stack([monic(cs), monic(cs[..., ::-1])], axis=0)
    zb = _dk_pass(both, n, ctype, n_iters)
    zf, zw = zb[0], zb[1]
    zw_safe = jnp.where(jnp.abs(zw) < 1e-20, 1e-20, zw)
    z = jnp.concatenate([zf, 1.0 / zw_safe], axis=-1)  # (..., 2n)
    re, im = jnp.real(z), jnp.imag(z)
    near_real = jnp.abs(im) < 1e-2 * (1.0 + jnp.abs(re))

    # polish real parts with Newton on the max-normalized polynomial
    def horner_d(x):
        acc = jnp.broadcast_to(cs[..., 0:1], x.shape).astype(x.dtype)
        dacc = jnp.zeros_like(x)
        for j in range(1, n + 1):
            dacc = dacc * x + acc
            acc = acc * x + cs[..., j:j + 1]
        return acc, dacc

    x = re
    for _ in range(3):
        p, dp = horner_d(x)
        x = x - p / jnp.where(jnp.abs(dp) < 1e-20, 1e-20, dp)
    return x, near_real


def _eval_poly(p, z):
    """p (..., P) high-to-low at z (...,) -> (...,)."""
    acc = p[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc * z + p[..., k]
    return acc


def _mono20_grad(x, y, z):
    """The 20 cubic monomials and their (x, y, z) partials at a batch of
    points -> four (..., 20) arrays."""
    vals, dxs, dys, dzs = [], [], [], []
    zero = jnp.zeros_like(x)
    for (i, j, k) in _MON20:
        xi = x ** i if i else 1.0
        yj = y ** j if j else 1.0
        zk = z ** k if k else 1.0
        one = jnp.ones_like(x)
        vals.append(xi * yj * zk * one)
        dxs.append(i * (x ** (i - 1) if i > 1 else 1.0) * yj * zk * one
                   if i else zero)
        dys.append(j * xi * (y ** (j - 1) if j > 1 else 1.0) * zk * one
                   if j else zero)
        dzs.append(k * xi * yj * (z ** (k - 1) if k > 1 else 1.0) * one
                   if k else zero)
    return (jnp.stack(vals, -1), jnp.stack(dxs, -1),
            jnp.stack(dys, -1), jnp.stack(dzs, -1))


def _inv3(A):
    """Closed-form 3x3 inverse via cofactors, A (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = jnp.stack([
        jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return co / det[..., None, None]


def _gn_polish(M, x, y, z, iters: int = 8, lam: float = 1e-10):
    """Gauss-Newton polish of candidate (x, y, z) on the original 10
    cubic constraints r = M mono20(x,y,z).  The expanded degree-10
    det B(z) loses ~3 digits to float32 coefficient cancellation; the
    cubic system itself is well-conditioned near a solution, so a few
    GN steps recover the accuracy the root extraction lost.  M (..., 10,
    20) row-normalized; x, y, z (..., C) candidates."""
    hi = jax.lax.Precision.HIGHEST
    eye3 = lam * jnp.eye(3, dtype=M.dtype)
    for _ in range(iters):
        v, dx, dy, dz = _mono20_grad(x, y, z)
        r = jnp.einsum("...qe,...ce->...cq", M, v, precision=hi)
        Jx = jnp.einsum("...qe,...ce->...cq", M, dx, precision=hi)
        Jy = jnp.einsum("...qe,...ce->...cq", M, dy, precision=hi)
        Jz = jnp.einsum("...qe,...ce->...cq", M, dz, precision=hi)
        J = jnp.stack([Jx, Jy, Jz], -1)                  # (..., C, 10, 3)
        JtJ = jnp.einsum("...qi,...qj->...ij", J, J, precision=hi) + eye3
        Jtr = jnp.einsum("...qi,...q->...i", J, r, precision=hi)
        step = jnp.einsum("...ij,...j->...i", _inv3(JtJ), Jtr, precision=hi)
        step = jnp.clip(step, -1.0, 1.0)
        x = x - step[..., 0]
        y = y - step[..., 1]
        z = z - step[..., 2]
    return x, y, z


def five_point(x1, x2, gn_iters: int = 8):
    """Essential matrices from 5 normalized correspondences.

    x1, x2: (..., 5, 2) -> (Es (..., 20, 3, 3), valid (..., 20)): up to
    10 real solutions in 20 candidate slots (forward + reversed root
    passes, see _roots_dk); invalid slots hold garbage matrices (score
    them anyway — they lose)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    Q = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                   u1, v1, one], axis=-1)             # (..., 5, 9)
    # 4-dim nullspace by branch-free Gauss-Jordan (any basis works for
    # the Nister parametrization; no batched QR)
    null = _nullspace4(Q)                             # (..., 9, 4)
    # Orthonormalize the basis (modified Gram-Schmidt): the raw GJ basis
    # can be wildly skewed, which poisons the float32 constraint matrix
    # and the det B(z) expansion downstream.
    ortho = []
    for k in range(4):
        v = null[..., k]
        for u in ortho:
            v = v - jnp.sum(v * u, -1, keepdims=True) * u
        n = jnp.sqrt(jnp.sum(v * v, -1, keepdims=True))
        ortho.append(v / jnp.maximum(n, 1e-20))
    null = jnp.stack(ortho, axis=-1)
    basis = jnp.swapaxes(null, -1, -2).reshape(*null.shape[:-2], 4, 3, 3)

    M = _constraint_matrix(basis)                     # (..., 10, 20)
    rn = jnp.max(jnp.abs(M), axis=-1, keepdims=True)
    M = M / jnp.maximum(rn, 1e-30)                    # row equilibration
    a, b, c = _bz_rows(M)
    det = _det_bz(a, b, c)                            # (..., 11)
    z, valid = _roots_dk(det)                         # (..., 10)

    # (x, y) from the nullspace of B(z0): cross product of the two
    # most independent rows (all three pairs, pick the largest)
    az = _eval_poly(a[..., None, :, :], z[..., None])   # (..., 10, 3)
    bz = _eval_poly(b[..., None, :, :], z[..., None])
    cz = _eval_poly(c[..., None, :, :], z[..., None])
    rows = jnp.stack([az, bz, cz], axis=-1)             # (..., 10, 3r, 3c)

    def cross(i, j):
        return jnp.cross(rows[..., i, :], rows[..., j, :])

    cands = jnp.stack([cross(0, 1), cross(0, 2), cross(1, 2)], axis=-2)
    nrm2 = jnp.sum(cands * cands, axis=-1)
    pick = jnp.argmax(nrm2, axis=-1)
    v = jnp.take_along_axis(cands, pick[..., None, None],
                            axis=-2)[..., 0, :]          # (..., 10, 3)
    w = jnp.where(jnp.abs(v[..., 2:]) > 1e-12, v[..., 2:], 1e-12)
    xy = v[..., :2] / w                                  # (..., 10, 2)

    # Gauss-Newton polish on the original cubic system (see _gn_polish).
    # Garbage slots (invalid roots, near-zero w) can enter with huge
    # coordinates and overflow the cubic monomials; clamp the entry point
    # and keep the unpolished candidate wherever the polish went
    # non-finite — those slots lose at scoring either way.
    cx = jnp.clip(xy[..., 0], -1e4, 1e4)
    cy = jnp.clip(xy[..., 1], -1e4, 1e4)
    cz_ = jnp.clip(z, -1e4, 1e4)
    px, py, pz = _gn_polish(M, cx, cy, cz_, iters=gn_iters)
    fin = jnp.isfinite(px) & jnp.isfinite(py) & jnp.isfinite(pz)
    px = jnp.where(fin, px, xy[..., 0])
    py = jnp.where(fin, py, xy[..., 1])
    pz = jnp.where(fin, pz, z)

    E = (px[..., None, None] * basis[..., None, 0, :, :]
         + py[..., None, None] * basis[..., None, 1, :, :]
         + pz[..., None, None] * basis[..., None, 2, :, :]
         + basis[..., None, 3, :, :])
    nrm = jnp.sqrt(jnp.sum(E * E, axis=(-1, -2), keepdims=True))
    E = E / jnp.maximum(nrm, 1e-12)
    # Invalid root slots can carry inf/nan through the candidate math;
    # replace them with a unit-norm placeholder and mark them invalid so
    # downstream scoring stays finite.
    fin_E = jnp.all(jnp.isfinite(E), axis=(-1, -2))
    eyeE = jnp.broadcast_to(jnp.eye(3, dtype=E.dtype) / jnp.sqrt(3.0),
                            E.shape)
    E = jnp.where(fin_E[..., None, None], E, eyeE)
    return E, valid & fin_E
