"""SURF descriptor extraction (64-d / extended 128-d, upright or rotated).

JAX re-derivation of describeURWithoutNormalization /
describeApproxWithoutNormalization + placeInIndex + normalize
(surfd.cu:1288-1317, 1566-1615, 2391-2444, 1199-1271, 2447-2493).

The reference runs one thread per sample: it gathers the sample's Haar
responses from the integral image and atomically scatter-adds its
bilinear contribution into a 4x4x4 global descriptor grid.  Here:

1.  **Wavelet sampling** — per-sample integral-image gathers, the
    reference's own design.

2.  **Binning** — the bilinear scatter reformulated as a factorized
    one-hot contraction: each sample produces a row-weight 4-vector, a
    column-weight 4-vector and an orientation-channel value vector, and
    the descriptor is the einsum over samples (deterministic, no
    atomics).  Per-keypoint sampling windows are padded to the static
    `cfg.max_iradius` bound (the analogue of the reference's global
    d_iradius readback, surfd.cu:3267-3279) and masked.

Keypoints are processed in chunks via lax.map to bound the live memory
footprint.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SurfConfig
from .integral import wavelet_dx, wavelet_dy


def describe(ii: jnp.ndarray, cfg: SurfConfig,
             x: jnp.ndarray, y: jnp.ndarray, scale: jnp.ndarray,
             ori: jnp.ndarray, valid: jnp.ndarray,
             chunk: int = 256, row_base=None,
             frame_hw=None) -> jnp.ndarray:
    """-> (K, nfeatures) float32 L2-normalized descriptors.

    `row_base` (K,) int32 + `frame_hw` (ih, iw): frame-stacked mode —
    `ii` holds B frames' integral images stacked vertically at
    `row_base` offsets (x/y stay frame-local); border checks run on
    frame-local coordinates against `frame_hw`, sampling on the stacked
    rows.  Used by the batched frontend to describe all frames'
    keypoints in one call."""
    k = x.shape[0]

    if cfg.doubled:
        x, y = 2 * x, 2 * y
        work = jnp.float32(3.3) * scale
    else:
        work = jnp.float32(1.65) * scale
    step = jnp.maximum(jnp.round(work * 0.5).astype(jnp.int32), 1)
    ix = jnp.round(x).astype(jnp.int32)
    iy = jnp.round(y).astype(jnp.int32)
    fracx = x - ix.astype(jnp.float32)
    fracy = y - iy.astype(jnp.float32)
    spacing = work * jnp.float32(cfg.mag_factor)
    iscale = jnp.trunc(work).astype(jnp.int32)
    radf = jnp.float32(1.0 if cfg.upright else 1.4)
    iradius = jnp.round(radf * spacing * jnp.float32((cfg.desc_wsz + 1) * 0.5)
                        / step.astype(jnp.float32)).astype(jnp.int32)
    if cfg.upright:
        sine = jnp.zeros_like(x)
        cose = jnp.ones_like(x)
        fracr, fracc = fracy, fracx
    else:
        sine, cose = jnp.sin(ori), jnp.cos(ori)
        fracr = cose * fracy + sine * fracx
        fracc = -sine * fracy + cose * fracx

    ih, iw = frame_hw if frame_hw is not None else ii.shape
    base = row_base if row_base is not None else jnp.zeros_like(ix)
    pad = (-k) % chunk
    args = [jnp.pad(a, (0, pad)) for a in
            (ix, iy, step, iradius, iscale, spacing, fracr, fracc,
             sine, cose, base)]
    args.append(jnp.pad(valid, (0, pad)))
    stacked = [a.reshape(-1, chunk, *a.shape[1:]) for a in args]
    out = lax.map(lambda t: _describe_chunk(ii, cfg, ih, iw, *t),
                  tuple(stacked))
    return out.reshape(-1, cfg.nfeatures)[:k]


def _describe_chunk(ii, cfg: SurfConfig, ih, iw, ix, iy, step, iradius,
                    iscale, spacing, fracr, fracc, sine, cose, base,
                    valid):
    wsz = cfg.desc_wsz
    osz = cfg.orient_size
    wofs = jnp.float32(wsz * 0.5 - 0.5)

    n = cfg.desc_grid
    g = jnp.arange(n, dtype=jnp.int32) - cfg.max_iradius
    i_ = jnp.repeat(g, n)     # (S,)
    j_ = jnp.tile(g, n)

    def one(ix, iy, step, iradius, iscale, spacing, fracr, fracc,
            sine, cose, base, valid):
        inwin = (jnp.abs(i_) <= iradius) & (jnp.abs(j_) <= iradius) & valid
        stepf = step.astype(jnp.float32)
        fi = i_.astype(jnp.float32)
        fj = j_.astype(jnp.float32)
        rpos = (stepf * (cose * fi + sine * fj) - fracr) / spacing
        cpos = (stepf * (-sine * fi + cose * fj) - fracc) / spacing
        rx = rpos + wofs
        cx = cpos + wofs
        ok = inwin & (rx > -1) & (rx < wsz) & (cx > -1) & (cx < wsz)
        r = iy + i_ * step
        c = ix + j_ * step
        ok &= (r >= 1 + iscale) & (r < ih - 1 - iscale) \
            & (c >= 1 + iscale) & (c < iw - 1 - iscale)
        widx = jnp.trunc(rpos * rpos + cpos * cpos)
        # lookup2[n] = exp(-(n+.5)/8) (surf.cpp:366-370): evaluate the
        # expression directly instead of gathering from the 40-entry LUT.
        weight = jnp.exp(-(jnp.clip(widx, 0, 39) + jnp.float32(0.5))
                         * jnp.float32(0.125))
        rc = jnp.clip(r, iscale, ih - iscale - 2) + base
        cc = jnp.clip(c, iscale, iw - iscale - 2)
        wdx = wavelet_dx(ii, cc, rc, iscale).astype(jnp.float32)
        wdy = wavelet_dy(ii, cc, rc, iscale).astype(jnp.float32)
        dxx = weight * wdx * jnp.float32(0.003921568627)
        dyy = weight * wdy * jnp.float32(0.003921568627)
        if cfg.upright:
            dx, dy = dxx, dyy
        else:
            dx = cose * dxx + sine * dyy
            dy = sine * dxx - cose * dyy

        # placeInIndex as a factorized one-hot contraction.
        ri = jnp.floor(rx).astype(jnp.int32)
        ci = jnp.floor(cx).astype(jnp.int32)
        rfrac = rx - ri.astype(jnp.float32)
        cfrac = cx - ci.astype(jnp.float32)

        def axis_w(i0, frac):
            # weighted one-hot over the wsz cells for (i0, 1-frac), (i0+1, frac)
            w0 = jax.nn.one_hot(jnp.where((i0 >= 0) & (i0 < wsz), i0, wsz),
                                wsz, dtype=jnp.float32) * (1 - frac)[:, None]
            i1 = i0 + 1
            w1 = jax.nn.one_hot(jnp.where((i1 >= 0) & (i1 < wsz), i1, wsz),
                                wsz, dtype=jnp.float32) * frac[:, None]
            return w0 + w1  # (S, wsz)

        rw = axis_w(ri, rfrac) * ok[:, None]
        cw = axis_w(ci, cfrac)
        if not cfg.extended:
            ov = (jnp.where(dx < 0, dx, 0)[:, None] * _eye(osz, 0)
                  + jnp.where(dx < 0, 0, dx)[:, None] * _eye(osz, 1)
                  + jnp.where(dy < 0, dy, 0)[:, None] * _eye(osz, 2)
                  + jnp.where(dy < 0, 0, dy)[:, None] * _eye(osz, 3))
        else:
            adx, ady = jnp.abs(dx), jnp.abs(dy)
            neg_y = dyy < 0
            neg_x = dxx < 0
            ov = (jnp.where(neg_y, dx, 0)[:, None] * _eye(osz, 0)
                  + jnp.where(neg_y, 0, dx)[:, None] * _eye(osz, 1)
                  + jnp.where(neg_y, adx, 0)[:, None] * _eye(osz, 2)
                  + jnp.where(neg_y, 0, adx)[:, None] * _eye(osz, 3)
                  + jnp.where(neg_x, dy, 0)[:, None] * _eye(osz, 4)
                  + jnp.where(neg_x, 0, dy)[:, None] * _eye(osz, 5)
                  + jnp.where(neg_x, ady, 0)[:, None] * _eye(osz, 6)
                  + jnp.where(neg_x, 0, ady)[:, None] * _eye(osz, 7))
        co = jnp.einsum("sc,so->sco", cw, ov, precision="float32")             # (S, wsz, osz)
        desc = jnp.einsum("sr,sco->rco", rw, co, precision="float32")          # (wsz, wsz, osz)
        return desc.reshape(-1)

    desc = jax.vmap(one)(ix, iy, step, iradius, iscale, spacing,
                         fracr, fracc, sine, cose, base, valid)
    return l2_normalize(desc)


def _eye(n, i):
    return jax.nn.one_hot(i, n, dtype=jnp.float32)


def l2_normalize(desc: jnp.ndarray) -> jnp.ndarray:
    """Per-descriptor L2 normalization (normalize, surfd.cu:2447-2493)."""
    nrm = jnp.sqrt(jnp.sum(desc * desc, axis=-1, keepdims=True))
    return desc / jnp.maximum(nrm, 1e-30)
