"""Haar-wavelet orientation assignment.

JAX re-derivation of assignOrientationApprox (surfd.cu:1711-1960).
The reference builds four shared-memory histograms with atomicAdd scatter;
here every histogram is a one-hot matmul (segment sum) batched over
keypoints, the +/-2pi wrapped copies of the angle-mass histogram are
derived algebraically instead of scattered, and the pi/3 sliding-window
sums become a (72, 13) gather + weighted reduction.  The windowed argmax
takes the first maximum, matching the reference's tie-keeps-lower-index
tree reduction (surfd.cu:1920-1947).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax import lax
import jax.numpy as jnp

from ..config import NBIN, SEP_ANGLE, WINDOW, HWN, ORADIUS, ORADIUS_SQ, SurfConfig, lut1, bin_centers
from .integral import wavelet_dx, wavelet_dy

# np scalars, not jnp: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize()
import numpy as _np
_PI = _np.float32(math.pi)
_2PI = _np.float32(2 * math.pi)


def fast_atan2(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Polynomial atan2 approximation (dFastAtan2, surfd.cu:114-126)."""
    absx, absy = jnp.abs(x), jnp.abs(y)
    a = jnp.minimum(absx, absy) / jnp.maximum(absx, absy)
    s = a * a
    r = ((jnp.float32(-0.0464964749) * s + jnp.float32(0.15931422)) * s
         - jnp.float32(0.327622764)) * s * a + a
    r = jnp.where(absy > absx, jnp.float32(math.pi / 2) - r, r)
    r = jnp.where(x < 0, _PI - r, r)
    r = jnp.where(y < 0, -r, r)
    return r


def assign_orientations(ii: jnp.ndarray, cfg: SurfConfig,
                        x: jnp.ndarray, y: jnp.ndarray, scale: jnp.ndarray,
                        valid: jnp.ndarray) -> jnp.ndarray:
    """Batched orientation for (K,) keypoints -> (K,) angles."""
    lut = jnp.asarray(lut1(), jnp.float32)
    bins = jnp.asarray(bin_centers(), jnp.float32)
    ih, iw = ii.shape
    k = x.shape[0]

    if cfg.doubled:
        x, y, scale = 2 * x, 2 * y, 2 * scale
    pixsi = jnp.trunc(2 * scale + jnp.float32(1.6)).astype(jnp.int32)
    step = jnp.trunc(scale + jnp.float32(0.8)).astype(jnp.int32)
    cx = jnp.round(x).astype(jnp.int32)
    cy = jnp.round(y).astype(jnp.int32)

    # chunk the histogram stage so the per-sample bin one-hots stay
    # bounded (~(chunk, 361, 72) f32), instead of K x 361 x 72 at once
    chunk = 512
    pad = (-k) % chunk
    args = [jnp.pad(a, (0, pad)) for a in (cx, cy, pixsi, step)]
    args.append(jnp.pad(valid, (0, pad)))
    stacked = [a.reshape(-1, chunk, *a.shape[1:]) for a in args]

    g = jnp.arange(-ORADIUS, ORADIUS + 1, dtype=jnp.int32)
    y1 = jnp.repeat(g, 2 * ORADIUS + 1)      # (361,)
    x1 = jnp.tile(g, 2 * ORADIUS + 1)
    distsq = y1 * y1 + x1 * x1               # (361,)

    def one(cx, cy, pixsi, step, valid):
        xx = cx + x1 * step
        yy = cy + y1 * step
        ok = ((yy + pixsi + 2 < ih) & (yy - pixsi > -1)
              & (xx + pixsi + 2 < iw) & (xx - pixsi > -1)
              & (distsq < ORADIUS_SQ) & valid)
        xxc = jnp.clip(xx, pixsi, iw - pixsi - 2)
        yyc = jnp.clip(yy, pixsi, ih - pixsi - 2)
        wdx = wavelet_dx(ii, xxc, yyc, pixsi).astype(jnp.float32)
        wdy = wavelet_dy(ii, xxc, yyc, pixsi).astype(jnp.float32)
        dx = wdx * jnp.float32(0.003921568627)
        dy = wdy * jnp.float32(0.003921568627)
        mag = jnp.sqrt(dx * dx + dy * dy)
        ok &= mag > 0
        angle = fast_atan2(dy, dx)
        hid = (jnp.trunc((angle + _PI) / jnp.float32(SEP_ANGLE))
               .astype(jnp.int32) % NBIN)
        psum = lut[jnp.clip(distsq, 0, lut.shape[0] - 1)] * mag

        onehot = jax.nn.one_hot(jnp.where(ok, hid, NBIN), NBIN,
                                dtype=jnp.float32)  # invalid -> all-zero row
        vals = jnp.stack([jnp.ones_like(psum), angle, psum, angle * psum], 1)
        sums = jnp.einsum("sb,sv->bv", onehot,
                  jnp.where(ok[:, None], vals, 0.0),
                  precision="float32")  # (NBIN, 4)
        return sums

    sums = lax.map(lambda t: jax.vmap(one)(*t), tuple(stacked))
    sums = sums.reshape(-1, NBIN, 4)[:k]                 # (K, NBIN, 4)
    hist, angsum = sums[:, :, 0], sums[:, :, 1]
    part_sums, angpsum = sums[:, :, 2], sums[:, :, 3]

    # The pi/3 sliding-window stage, batched over ALL keypoints with
    # static tables as constants, static wraps as rolls/slices, and the
    # 11-bin window sums as one constant-banded matmul each, in place
    # of vmapped per-keypoint gathers.
    avg = jnp.where(hist > 0, angsum / jnp.maximum(hist, 1.0),
                    bins[None, :])
    # part_angle_sums with wrapped copies (surfd.cu:1798-1806):
    # slot b+HWN holds bin b; low slots hold bins 66..71 shifted by
    # -2pi, high slots hold bins 0..5 shifted by +2pi.
    pas = jnp.concatenate([
        angpsum[:, NBIN - HWN:] - _2PI * part_sums[:, NBIN - HWN:],
        angpsum,
        angpsum[:, :HWN] + _2PI * part_sums[:, :HWN],
    ], axis=1)  # (K, NBIN + 2*HWN)

    idx = np.arange(NBIN)
    js = np.arange(-HWN + 1, HWN)                        # (11,)
    kmat = idx[:, None] + js[None, :]                    # (72, 11)
    WA = np.zeros((NBIN + 2 * HWN, NBIN), np.float32)
    np.add.at(WA, (np.ravel(kmat + HWN),
                   np.repeat(idx, len(js))), 1.0)
    WS = np.zeros((NBIN, NBIN), np.float32)
    np.add.at(WS, (np.ravel(kmat % NBIN),
                   np.repeat(idx, len(js))), 1.0)
    # full f32 precision: a reduced-precision matmul (bf16 or TF32
    # passes, ~2^-8 / 2^-11 relative) flips near-tie windows against
    # the reference's scalar f32 sums (observed: two left.pgm keypoints
    # with top-2 window gaps of 8.5e-4 picking the wrong window -> a
    # pi-flipped orientation and descriptor cosine 0.68 vs the oracle)
    win_asums = jnp.matmul(pas, jnp.asarray(WA),
                           precision=lax.Precision.HIGHEST)
    win_sums = jnp.matmul(part_sums, jnp.asarray(WS),
                          precision=lax.Precision.HIGHEST)

    bins_np = np.asarray(bin_centers(), np.float32)
    half_w = np.float32(WINDOW / 2)
    # left edge j = -HWN (static tables; only `avg` is per-keypoint)
    kl = idx - HWN
    klw = np.where(kl < 0, kl + NBIN, kl)
    k1 = (klw + 1) % NBIN
    base_l = np.where(
        kl < 0,
        bins_np[k1] + half_w
        - np.where(bins_np[k1] < 0, 0.0, 2 * math.pi).astype(np.float32),
        bins_np[np.clip(kl + 1, 0, NBIN - 1)] + half_w)
    ratio_l = (jnp.asarray(base_l)[None, :] - avg) / jnp.float32(SEP_ANGLE)
    # part_sums[:, klw] is the static permutation b -> (b-HWN) % NBIN,
    # i.e. a roll; pas[:, 0:NBIN] is the same left-edge bin in the
    # wrapped-slot layout (slot b holds bin b-HWN with its -2pi shift)
    win_sums = win_sums + ratio_l * jnp.roll(part_sums, HWN, axis=1)
    win_asums = win_asums + ratio_l * pas[:, :NBIN]
    # right edge j = +HWN
    kr = idx + HWN
    krw = np.where(kr >= NBIN, kr - NBIN, kr)
    base_r = np.where(kr >= NBIN, -2 * math.pi - bins_np[krw],
                      -bins_np[krw]).astype(np.float32) + half_w
    ratio_r = (avg + jnp.asarray(base_r)[None, :]) / jnp.float32(SEP_ANGLE)
    win_sums = win_sums + ratio_r * jnp.roll(part_sums, -HWN, axis=1)
    win_asums = win_asums + ratio_r * pas[:, 2 * HWN:]

    sel = jax.nn.one_hot(jnp.argmax(win_sums, axis=1), NBIN,
                         dtype=jnp.float32)
    return (jnp.sum(sel * win_asums, axis=1)
            / jnp.sum(sel * win_sums, axis=1))
