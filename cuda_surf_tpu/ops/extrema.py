"""3x3x3 non-max extrema detection + iterative subpixel interpolation.

JAX re-derivation of findMaximumWithInterp (surfd.cu:676-832),
fitQuadrat (surfd.cu:942-988) and solveLinearSystem (surfd.cu:835-887).

The reference appends keypoints with atomicInc into a global array; XLA
needs static shapes, so detection is reformulated as:

  1. a dense vectorized NMS pass: a position is a candidate iff its
     response beats the 0.8*thresh pre-filter and is >= the max of its
     full 3x3x3 neighbourhood, within the reference's per-scale-pair
     cell windows.  This is mathematically the reference's
     cell-argmax-then-26-neighbour test (surfd.cu:757-792) except that
     exact response ties inside a cell admit both points instead of the
     first in `cas` order — ties essentially never survive the
     threshold on real images.  All dense vector ops: no gathers, no
     strided slices.

  2. one global stream compaction of candidate *linear indices* across
     all octaves into a fixed-size buffer (types.compact).

  3. a batched fixed-iteration interpolation walk.  The quadratic fit
     (the reference's float32 partial-pivot Gaussian elimination, pivot
     swaps as selects) is solved DENSELY at every pyramid position from
     shifted-difference stencil maps — pure vector math — so each walk
     step is just a flat 4-value gather [off_s, off_r, off_c, strength]
     per candidate; after the first step the still-walking candidates
     are compacted into a half-capacity active set (the reference's
     per-thread early exit with static shapes).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import SurfConfig, OctaveSchedule
from ..types import compact


def solve3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """3x3 float32 Gaussian elimination with partial pivoting
    (solveLinearSystem, surfd.cu:835-887), branch- and gather-free.
    Singular systems produce inf/nan which downstream rejection
    filters, as in the reference."""
    M = jnp.concatenate([A, b[:, None]], axis=1).astype(jnp.float32)

    def pick(p, r0, r1, r2):
        return jnp.where(p == 0, r0, jnp.where(p == 1, r1, r2))

    # pivot for column 0 over rows 0..2
    a = jnp.abs(M[:, 0])
    p0 = jnp.where(a[1] > a[0], 1, 0)
    p0 = jnp.where(a[2] > jnp.maximum(a[0], a[1]), 2, p0)
    r0 = pick(p0, M[0], M[1], M[2])
    r1 = jnp.where(p0 == 1, M[0], M[1])
    r2 = jnp.where(p0 == 2, M[0], M[2])
    r1 = r1 - (r1[0] / r0[0]) * r0
    r2 = r2 - (r2[0] / r0[0]) * r0
    # pivot for column 1 over rows 1..2
    swap = jnp.abs(r2[1]) > jnp.abs(r1[1])
    r1, r2 = (jnp.where(swap, r2, r1), jnp.where(swap, r1, r2))
    r2 = r2 - (r2[1] / r1[1]) * r1
    x2 = r2[3] / r2[2]
    x1 = (r1[3] - r1[2] * x2) / r1[1]
    x0 = (r0[3] - r0[1] * x1 - r0[2] * x2) / r0[0]
    return jnp.stack([x0, x1, x2])


def fit_stencils(resp: jnp.ndarray) -> jnp.ndarray:
    """Dense quadratic-fit inputs for every pyramid position.

    resp: (ms, oh, ow) -> (ms, oh, ow, 10) float32 holding
    [g_s, g_r, g_c, H_ss, H_rr, H_cc, H_sr, H_sc, H_rc, center]
    (central differences of fitQuadrat, surfd.cu:942-988).  Values in
    the one-cell border / end scales are garbage (zero-padded) but the
    walk never samples there.  Shifts are unit-offset slices of ONE
    zero-padded buffer — jnp.roll builds a concat chain per shift that
    XLA cannot fuse into a single-buffer stencil read.
    """
    ms, oh, ow = resp.shape
    rp = jnp.pad(resp, ((1, 1), (1, 1), (1, 1)))

    def sh(_, ds, dr, dc):
        return lax.slice(rp, (1 + ds, 1 + dr, 1 + dc),
                         (1 + ds + ms, 1 + dr + oh, 1 + dc + ow))

    c = resp
    half = jnp.float32(0.5)
    quarter = jnp.float32(0.25)
    two = jnp.float32(2.0)
    g_s = (sh(c, 1, 0, 0) - sh(c, -1, 0, 0)) * half
    g_r = (sh(c, 0, 1, 0) - sh(c, 0, -1, 0)) * half
    g_c = (sh(c, 0, 0, 1) - sh(c, 0, 0, -1)) * half
    h_ss = sh(c, 1, 0, 0) + sh(c, -1, 0, 0) - two * c
    h_rr = sh(c, 0, 1, 0) + sh(c, 0, -1, 0) - two * c
    h_cc = sh(c, 0, 0, 1) + sh(c, 0, 0, -1) - two * c
    h_sr = ((sh(c, 1, 1, 0) - sh(c, 1, -1, 0))
            - (sh(c, -1, 1, 0) - sh(c, -1, -1, 0))) * quarter
    h_sc = ((sh(c, 1, 0, 1) - sh(c, 1, 0, -1))
            - (sh(c, -1, 0, 1) - sh(c, -1, 0, -1))) * quarter
    h_rc = ((sh(c, 0, 1, 1) - sh(c, 0, 1, -1))
            - (sh(c, 0, -1, 1) - sh(c, 0, -1, -1))) * quarter
    return jnp.stack(
        [g_s, g_r, g_c, h_ss, h_rr, h_cc, h_sr, h_sc, h_rc, c], axis=-1)


def _fit_closed_form(g_s, g_r, g_c, h_ss, h_rr, h_cc, h_sr, h_sc, h_rc,
                     center):
    """Elementwise partial-pivot 3x3 solve + peak strength from fit
    stencil values (any broadcastable shapes).  Same math as
    :func:`solve3` (solveLinearSystem, surfd.cu:835-887) with the pivot
    selects evaluated per element."""
    # rows of [H | -g]
    rows = [
        [h_ss, h_sr, h_sc, -g_s],
        [h_sr, h_rr, h_rc, -g_r],
        [h_sc, h_rc, h_cc, -g_c],
    ]

    def pick(p, a, b, c):
        return jnp.where(p == 0, a, jnp.where(p == 1, b, c))

    a0, a1, a2 = (jnp.abs(rows[0][0]), jnp.abs(rows[1][0]),
                  jnp.abs(rows[2][0]))
    p0 = jnp.where(a1 > a0, 1, 0)
    p0 = jnp.where(a2 > jnp.maximum(a0, a1), 2, p0)
    r0 = [pick(p0, rows[0][j], rows[1][j], rows[2][j]) for j in range(4)]
    r1 = [jnp.where(p0 == 1, rows[0][j], rows[1][j]) for j in range(4)]
    r2 = [jnp.where(p0 == 2, rows[0][j], rows[2][j]) for j in range(4)]
    f1 = r1[0] / r0[0]
    f2 = r2[0] / r0[0]
    r1 = [r1[j] - f1 * r0[j] for j in range(4)]
    r2 = [r2[j] - f2 * r0[j] for j in range(4)]
    swap = jnp.abs(r2[1]) > jnp.abs(r1[1])
    r1, r2 = ([jnp.where(swap, r2[j], r1[j]) for j in range(4)],
              [jnp.where(swap, r1[j], r2[j]) for j in range(4)])
    f3 = r2[1] / r1[1]
    r2 = [r2[j] - f3 * r1[j] for j in range(4)]
    x2 = r2[3] / r2[2]
    x1 = (r1[3] - r1[2] * x2) / r1[1]
    x0 = (r0[3] - r0[1] * x1 - r0[2] * x2) / r0[0]
    strength = center + jnp.float32(0.5) * (
        x0 * g_s + x1 * g_r + x2 * g_c)
    return x0, x1, x2, strength


def fit_dense(resp: jnp.ndarray):
    """Dense quadratic fit solved at every pyramid position.

    -> (ms, oh, ow, 4) float32 [off_s, off_r, off_c, peak_strength]:
    the same partial-pivot Gaussian elimination as :func:`solve3`
    evaluated elementwise over the whole pyramid, so the interpolation
    walk only gathers 4 precomputed values per candidate instead of 10
    stencils + a batched solve.  Border/end-scale values are garbage
    (never sampled); singular fits give inf/nan (filtered downstream).
    """
    st = fit_stencils(resp)
    x0, x1, x2, strength = _fit_closed_form(*[st[..., k] for k in range(10)])
    return jnp.stack([x0, x1, x2, strength], axis=-1)


# Stencil gather offsets for the sparse per-candidate fit: every
# distinct (ds, dr, dc) the 10 fit inputs touch (19 of the 27
# neighbours; corners of the 3x3x3 cube are unused).
_FIT_OFFSETS = [
    (0, 0, 0),
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
    (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
    (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
]


def fit_sparse(resp_flat: jnp.ndarray, lin: jnp.ndarray,
               plane: jnp.ndarray, ow: jnp.ndarray):
    """Per-candidate quadratic fit: gather the 19 stencil neighbours of
    each candidate with flat takes and run the closed-form solve on
    (cap,) vectors — the alternative to :func:`fit_dense`'s
    every-position maps (dense: ~50-op expression + a 16-byte write per
    pyramid cell, ~98% of which is never read; sparse: 19 gathers per
    candidate).  Candidates sit strictly inside the per-scale windows
    (mask borders >= 1, scales 1..ms-2) and the walk clamps to the same
    interior, so every neighbour index stays inside the candidate's own
    octave block.

    resp_flat: (T,) all-octave flattened pyramid; lin: (cap,) flat
    indices; plane: (cap,) per-candidate scale-plane size (oh*ow);
    ow: (cap,) per-candidate row stride.  Returns (off_s, off_r,
    off_c, strength), each (cap,).
    """
    vals = {}
    for ds, dr, dc in _FIT_OFFSETS:
        off = ds * plane + dr * ow + dc
        vals[(ds, dr, dc)] = jnp.take(resp_flat, lin + off)

    def v(ds, dr, dc):
        return vals[(ds, dr, dc)]

    half, quarter, two = (jnp.float32(0.5), jnp.float32(0.25),
                          jnp.float32(2.0))
    c = v(0, 0, 0)
    g_s = (v(1, 0, 0) - v(-1, 0, 0)) * half
    g_r = (v(0, 1, 0) - v(0, -1, 0)) * half
    g_c = (v(0, 0, 1) - v(0, 0, -1)) * half
    h_ss = v(1, 0, 0) + v(-1, 0, 0) - two * c
    h_rr = v(0, 1, 0) + v(0, -1, 0) - two * c
    h_cc = v(0, 0, 1) + v(0, 0, -1) - two * c
    h_sr = ((v(1, 1, 0) - v(1, -1, 0)) - (v(-1, 1, 0) - v(-1, -1, 0))
            ) * quarter
    h_sc = ((v(1, 0, 1) - v(1, 0, -1)) - (v(-1, 0, 1) - v(-1, 0, -1))
            ) * quarter
    h_rc = ((v(0, 1, 1) - v(0, 1, -1)) - (v(0, -1, 1) - v(0, -1, -1))
            ) * quarter
    return _fit_closed_form(g_s, g_r, g_c, h_ss, h_rr, h_cc,
                            h_sr, h_sc, h_rc, c)


def _candidate_mask(resp: jnp.ndarray, osched: OctaveSchedule,
                    cfg: SurfConfig) -> jnp.ndarray:
    """Dense NMS candidate mask, (ms, oh, ow) bool."""
    ms, oh, ow = resp.shape
    # separable 3x3x3 max (same result, cheaper than one 3-D window)
    nbhd_max = resp
    for ax, dims in ((0, (3, 1, 1)), (1, (1, 3, 1)), (2, (1, 1, 3))):
        nbhd_max = lax.reduce_window(nbhd_max, -jnp.inf, lax.max, dims,
                                     (1, 1, 1), "SAME")
    pre = resp >= jnp.float32(0.8) * jnp.float32(cfg.thresh)
    is_max = resp >= nbhd_max

    # per-scale cell windows as an outer product of static 1-D masks
    mborders = osched.maximum_borders()
    row_ok = np.zeros((ms, oh, 1), bool)
    col_ok = np.zeros((ms, 1, ow), bool)
    for s in range(ms):
        z = (s - 1) // 2
        # scales covered by the reference's 2x2x2 cells at layers
        # k = 2z+1: s in {2z+1, 2z+2}, except the very last scale plane
        # (the cas <= 3 restriction at surfd.cu:737).
        if 1 <= s < ms - 1 and z < len(mborders):
            mb = mborders[z]
            hc = max(0, (oh - 2 * mb - 1) // 2 + 1)
            wc = max(0, (ow - 2 * mb - 1) // 2 + 1)
            row_ok[s, mb:mb + 2 * hc, 0] = True
            col_ok[s, 0, mb:mb + 2 * wc] = True
    window = jnp.asarray(row_ok) & jnp.asarray(col_ok)
    return pre & is_max & window


def detect(pyr, scheds, cfg: SurfConfig, cap: int | None = None,
           nframes: int = 1):
    """All-octave detection: dense NMS -> global compaction -> batched
    interpolation walk.  Returns dict of (cap,) arrays:
    valid, nx, ny, ns, strength, octave (octave-local interpolated
    coords, ready for makePoint scaling).

    `nframes=B` FRAME-STACKS the sparse stages: pyr entries carry a
    leading (B, ...) frame axis, and ONE compaction + ONE interpolation
    walk run over the union of all B frames' candidates (cap scales to
    B*cap) — the per-frame formulation pays its dozens of fixed-overhead
    gather/scan kernels B times, the union pays them once.  Buffers are
    laid out frame-major so each frame's block reproduces the
    single-frame layout; the returned dict gains `frame` ids."""
    noct = len(pyr)
    if cap is None:
        cap = cfg.max_candidates
    cap = cap * nframes

    sparse_fit = getattr(cfg, "detect_fit", "dense") == "sparse"
    B = nframes
    batched = pyr[0].ndim == 4      # leading frame axis (even for B=1)
    masks, stens, offs, shapes = [], [], [0], []
    for o in range(noct):
        resp = pyr[o]
        if not batched:
            m = _candidate_mask(resp, scheds[o], cfg)
        else:
            m = jax.vmap(lambda r: _candidate_mask(r, scheds[o], cfg))(resp)
        masks.append(m.reshape(B, -1))
        if not sparse_fit:
            f = fit_dense(resp) if not batched else jax.vmap(fit_dense)(resp)
            stens.append(f.reshape(B, -1, 4))
        offs.append(offs[-1] + resp.size // B)
        shapes.append(resp.shape[-3:])
    # frame-major flat layout: [frame0: oct0..octN | frame1: ...]
    mask = jnp.concatenate(masks, axis=1).reshape(-1)
    if sparse_fit:
        resp_flat = jnp.concatenate(
            [r.reshape(B, -1) for r in pyr], axis=1).reshape(-1)
        sten = None
    else:
        # ONE flat (4*T,) buffer [off_s | off_r | off_c | strength]:
        # the walk gathers all four values per candidate in a single
        # 1-D take (4 separate takes are 4 gather kernels per walk
        # step; row-gathers of a (T, 4) layout measured slower still)
        sten = jnp.concatenate(
            [jnp.concatenate([s[:, :, k] for s in stens],
                             axis=1).reshape(-1) for k in range(4)])
    total_f = offs[-1]          # per-frame element count
    total = total_f * B

    lin0 = lax.broadcasted_iota(jnp.int32, (total, 1), 0)[:, 0]
    count, valid, lin = compact(mask, cap, lin0)

    # --- static per-candidate geometry decoded from the linear index ---
    # (frame block first, then the single-frame octave decode on the
    # frame-relative index; fit gathers keep the GLOBAL index)
    if B > 1:
        frame = lin // total_f
        rel_lin = lin - frame * total_f
    else:
        frame = jnp.zeros((cap,), jnp.int32)
        rel_lin = lin
    octv = jnp.zeros((cap,), jnp.int32)
    for o in range(1, noct):
        octv += (rel_lin >= offs[o]).astype(jnp.int32)

    def sel(table):
        v = jnp.full((cap,), table[0], jnp.int32)
        for o in range(1, noct):
            v = jnp.where(octv == o, table[o], v)
        return v

    oh_t = sel([sh[1] for sh in shapes])
    ow_t = sel([sh[2] for sh in shapes])
    off_t = sel(offs[:-1])
    rel = rel_lin - off_t
    s_idx = rel // (oh_t * ow_t)
    rem = rel - s_idx * oh_t * ow_t
    r = rem // ow_t
    c = rem - r * ow_t

    # per-(octave, scale) walk border table (surf.cpp:261-269)
    ms_p = max(len(s.borders) for s in scheds)
    btab = []
    for o in range(noct):
        bs = list(scheds[o].borders)
        btab += bs + [0] * (ms_p - len(bs))
    btab = jnp.asarray(btab, jnp.int32)
    border = btab[octv * ms_p + s_idx]

    # --- interpolation walk (fixed iterations, flat gathers) -----------
    def fit(lin_idx, oh_i, ow_i):
        if sparse_fit:
            x0, x1, x2, s = fit_sparse(resp_flat, lin_idx, oh_i * ow_i,
                                       ow_i)
            return jnp.stack([x0, x1, x2], -1), s
        k4 = jnp.arange(4, dtype=jnp.int32)[:, None] * total
        v = jnp.take(sten, (lin_idx[None, :] + k4).reshape(-1)
                     ).reshape(4, -1)
        return jnp.stack([v[0], v[1], v[2]], -1), v[3]

    def step(lin, r, c, border, oh_t, ow_t, active):
        """One fit + walk move; returns fit outputs and moved state."""
        off_new, strength_new = fit(lin, oh_t, ow_t)
        dr = (jnp.where(active & (off_new[:, 1] > 0.6) & (r < oh_t - border), 1, 0)
              - jnp.where(active & (off_new[:, 1] < -0.6) & (r > border), 1, 0))
        dc = (jnp.where(active & (off_new[:, 2] > 0.6) & (c < ow_t - border), 1, 0)
              - jnp.where(active & (off_new[:, 2] < -0.6) & (c > border), 1, 0))
        moved = active & ((dr != 0) | (dc != 0))
        return (off_new, strength_new, r, c,
                lin + dr * ow_t + dc, r + dr, c + dc, moved)

    # Iteration 1 runs on all candidates; the (few) that need to keep
    # walking are compacted into a half-capacity active set for the
    # remaining iterations — the reference's early-exit (moves_remain,
    # surfd.cu:800-809) expressed with static shapes.
    off, strength, r_fit, c_fit, lin, r, c, active = step(
        lin, r, c, border, oh_t, ow_t, valid)
    off = jnp.where(valid[:, None], off, 0.0)
    strength = jnp.where(valid, strength, 0.0)

    # Walkers are rare (~1-2% of candidates move on real images: 78/111
    # of 8192 on the reference fixtures), so the remaining iterations
    # run on a cap//8 active set — overflow actives keep their
    # first-iteration fit, as before.
    cap2 = max(cap // 8, 64)
    slots = jnp.arange(cap, dtype=jnp.int32)
    (_, v2, idx2, lin2, r2, c2, b2, oh2, ow2) = compact(
        active, cap2, slots, lin, r, c, border, oh_t, ow_t)
    off2 = jnp.take(off, idx2, axis=0)
    strength2 = jnp.take(strength, idx2)
    rf2 = jnp.take(r_fit, idx2)
    cf2 = jnp.take(c_fit, idx2)
    act2 = v2
    for _ in range(cfg.interp_moves - 1):
        off_n, s_n, rf_n, cf_n, lin2, r2, c2, moved = step(
            lin2, r2, c2, b2, oh2, ow2, act2)
        off2 = jnp.where(act2[:, None], off_n, off2)
        strength2 = jnp.where(act2, s_n, strength2)
        rf2 = jnp.where(act2, rf_n, rf2)
        cf2 = jnp.where(act2, cf_n, cf2)
        act2 = moved

    # merge the walked subset back by rank-gather (compact is stable, so
    # the i-th active slot landed at compacted row i; dropped-overflow
    # actives keep their first-iteration fit); all six merged values
    # gather in ONE take
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    walked = active & (rank < cap2)
    rk = jnp.where(walked, rank, 0)
    wbuf = jnp.concatenate([off2[:, 0], off2[:, 1], off2[:, 2],
                            strength2, rf2, cf2])
    k6 = jnp.arange(6, dtype=jnp.int32)[:, None] * cap2
    wv = jnp.take(wbuf, (rk[None, :] + k6).reshape(-1)).reshape(6, -1)
    off = jnp.where(walked[:, None],
                    jnp.stack([wv[0], wv[1], wv[2]], -1), off)
    strength = jnp.where(walked, wv[3], strength)
    r_fit = jnp.where(walked, wv[4], r_fit)
    c_fit = jnp.where(walked, wv[5], c_fit)

    good = valid
    good &= ~jnp.any(jnp.isnan(off), axis=1)
    good &= ~jnp.any(jnp.abs(off) > 1.5, axis=1)
    good &= strength >= jnp.float32(cfg.thresh)

    octave = sel([sch.octave for sch in scheds]).astype(jnp.float32)
    ns = (jnp.float32(cfg.init_lobe)
          + (octave - 1.0) * jnp.float32(cfg.max_scale)
          + (s_idx.astype(jnp.float32) + off[:, 0]) * 2.0 * octave
          ) / jnp.float32(3.0)
    ny = octave * (r_fit.astype(jnp.float32) + off[:, 1])
    nx = octave * (c_fit.astype(jnp.float32) + off[:, 2])
    return dict(valid=good, nx=nx, ny=ny, ns=ns, strength=strength,
                octave=octv, frame=frame, count=count)


def detect_octave(resp: jnp.ndarray, osched: OctaveSchedule,
                  cfg: SurfConfig):
    """Single-octave convenience wrapper (used by unit tests)."""
    out = detect([resp], [osched], cfg, cap=cfg.candidates_per_octave)
    return out
