"""Pure-NumPy oracle of the reference SURF pipeline.

Independent re-derivation of the math in the reference's surfd.cu +
surf.cpp (see SURVEY.md section 3.5) used as the golden contract for the
JAX implementation.  Vectorized NumPy, float32 discipline where the
reference computes in float32.  The reference itself has no tests; its
"oracle" was CPU mirrors of device code (SURVEY.md section 4) — this file
plays that role for this build.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from cuda_surf_tpu.config import (
    NBIN, SEP_ANGLE, WINDOW, HWN, ORADIUS, ORADIUS_SQ,
    SurfConfig, lut1, lut2, bin_centers,
)

LUT1 = np.asarray(lut1(), np.float32)
LUT2 = np.asarray(lut2(), np.float32)
BINS = np.asarray(bin_centers(), np.float32)
R255 = np.float32(0.003921568627)


def rn(x):
    """__float2int_rn: round half to even."""
    return np.rint(x).astype(np.int64)


def rz(x):
    """__float2int_rz: truncate toward zero."""
    return np.trunc(x).astype(np.int64)


# ---------------------------------------------------------------- integral


def integral_image(img: np.ndarray, doubled: bool = False) -> np.ndarray:
    """Zero-padded int32 integral image (integralRow/Col, surfd.cu:129-165).

    I[y, x] = sum of img[:y, :x]; row 0 and column 0 are zero.  When
    `doubled`, the source is first 2x-upsampled with the reference's
    rounded bilinear scheme (integralDoubleRow0U2, surfd.cu:168-206).
    """
    src = img.astype(np.int64)
    if doubled:
        h, w = src.shape
        up = np.zeros((2 * h - 1, 2 * w - 1), np.int64)
        up[0::2, 0::2] = src
        up[0::2, 1::2] = rn((src[:, :-1] + src[:, 1:]) * np.float32(0.5))
        up[1::2, 0::2] = rn((src[:-1, :] + src[1:, :]) * np.float32(0.5))
        up[1::2, 1::2] = rn(
            (src[:-1, :-1] + src[:-1, 1:] + src[1:, :-1] + src[1:, 1:])
            * np.float32(0.25))
        src = up
    h, w = src.shape
    out = np.zeros((h + 1, w + 1), np.int64)
    out[1:, 1:] = src.cumsum(0).cumsum(1)
    return out.astype(np.int32)


def box_sum(ii: np.ndarray, x1, y1, x2, y2):
    """Inclusive box sum over cols [x2..x1], rows [y2..y1]
    (getSum, surfd.cu:334-343)."""
    ii64 = ii.astype(np.int64)
    return (ii64[y1 + 1, x1 + 1] + ii64[y2, x2]
            - ii64[y2, x1 + 1] - ii64[y1 + 1, x2])


# ----------------------------------------------------------------- hessian


def hessian_response(ii, cx, cy, m, x2, x3, x4):
    """Box-filter det-of-Hessian at integral coords (cx, cy), mask m
    (getHessian, surfd.cu:353-366)."""
    dxx = (box_sum(ii, cx + m + x2, cy + x3, cx - m - x2, cy - x3)
           - 3 * box_sum(ii, cx + x2, cy + x3, cx - x2, cy - x3)).astype(np.float32)
    dyy = (box_sum(ii, cx + x3, cy + m + x2, cx - x3, cy - m - x2)
           - 3 * box_sum(ii, cx + x3, cy + x2, cx - x3, cy - x2)).astype(np.float32)
    dxy = np.float32(0.6) * (
        box_sum(ii, cx + x4, cy, cx, cy - x4)
        + box_sum(ii, cx, cy + x4, cx - x4, cy)
        - box_sum(ii, cx + x4, cy + x4, cx, cy)
        - box_sum(ii, cx, cy, cx - x4, cy - x4)).astype(np.float32)
    return R255 * R255 * (dxx * dyy - dxy * dxy)


def laplace_sign(ii, cx, cy, m, x2, x3):
    """Sign of Dxx+Dyy (getTrace, surfd.cu:369-377)."""
    lxx = (box_sum(ii, cx + m + x2, cy + x3, cx - m - x2, cy - x3)
           - 3 * box_sum(ii, cx + x2, cy + x3, cx - x2, cy - x3))
    lyy = (box_sum(ii, cx + x3, cy + m + x2, cx - x3, cy - m - x2)
           - 3 * box_sum(ii, cx + x3, cy + x2, cx - x3, cy - x2))
    return np.where(lxx + lyy > 0, 1, -1)


def response_pyramid(ii: np.ndarray, cfg: SurfConfig, h: int, w: int):
    """All octaves' response maps: list of (max_scale, Ho, Wo) float32.

    Scales 0-1 of octaves > 0 are seeded by 2x decimation of scales
    max_scale-3 / max_scale-1 of the previous octave (surf.cpp:253-258);
    out-of-border entries are zero (steady-state omem memset,
    surf.cpp:348)."""
    shapes = cfg.octave_shapes(h, w)
    sched = cfg.hessian_schedule(h, w)
    pyr = []
    for o, (osched, (oh, ow)) in enumerate(zip(sched, shapes)):
        resp = np.zeros((cfg.max_scale, oh, ow), np.float32)
        if o > 0:
            resp[0] = pyr[o - 1][cfg.max_scale - 3][: 2 * oh : 2, : 2 * ow : 2]
            resp[1] = pyr[o - 1][cfg.max_scale - 1][: 2 * oh : 2, : 2 * ow : 2]
        for sp in osched.scales:
            b1, d = sp.border1, sp.delta
            ys = np.arange(b1, oh - b1)
            xs = np.arange(b1, ow - b1)
            if len(ys) == 0 or len(xs) == 0:
                continue
            cy = (d * ys)[:, None]
            cx = (d * xs)[None, :]
            resp[sp.scale_index, b1 : oh - b1, b1 : ow - b1] = (
                hessian_response(ii, cx, cy, sp.mask_size, sp.x2, sp.x3, sp.x4)
                * np.float32(sp.norm))
        pyr.append(resp)
    return pyr


# ----------------------------------------------------------------- extrema


@dataclasses.dataclass
class OraclePoint:
    x: float
    y: float
    scale: float
    strength: float
    laplace: int
    octave: int
    ori: float = 0.0


def _fit_quadrat(resp, s, r, c):
    """3D quadratic fit (fitQuadrat, surfd.cu:942-988)."""
    cur, prv, nxt = resp[s], resp[s - 1], resp[s + 1]
    g = np.array([
        (nxt[r, c] - prv[r, c]) * 0.5,
        (cur[r + 1, c] - cur[r - 1, c]) * 0.5,
        (cur[r, c + 1] - cur[r, c - 1]) * 0.5,
    ], np.float32)
    H = np.empty((3, 3), np.float32)
    t = cur[r, c] + cur[r, c]
    H[0, 0] = prv[r, c] + nxt[r, c] - t
    H[1, 1] = cur[r + 1, c] + cur[r - 1, c] - t
    H[2, 2] = cur[r, c + 1] + cur[r, c - 1] - t
    H[0, 1] = H[1, 0] = ((nxt[r + 1, c] - nxt[r - 1, c])
                         - (prv[r + 1, c] - prv[r - 1, c])) * 0.25
    H[0, 2] = H[2, 0] = ((nxt[r, c + 1] - nxt[r, c - 1])
                         - (prv[r, c + 1] - prv[r, c - 1])) * 0.25
    H[1, 2] = H[2, 1] = ((cur[r + 1, c + 1] - cur[r + 1, c - 1])
                         - (cur[r - 1, c + 1] - cur[r - 1, c - 1])) * 0.25
    with np.errstate(all="ignore"):
        try:
            off = np.linalg.solve(H.astype(np.float64), -g.astype(np.float64))
        except np.linalg.LinAlgError:
            off = np.full(3, np.nan)
    strength = cur[r, c] + 0.5 * float(off @ g.astype(np.float64))
    return off.astype(np.float64), float(strength)


def detect(ii, pyr, cfg: SurfConfig, h: int, w: int):
    """NMS + iterative subpixel interpolation
    (findMaximumWithInterp, surfd.cu:676-832)."""
    shapes = cfg.octave_shapes(h, w)
    sched = cfg.hessian_schedule(h, w)
    points: list[OraclePoint] = []
    for o in range(cfg.noctaves):
        resp = pyr[o]
        oh, ow = shapes[o]
        osched = sched[o]
        borders = osched.borders
        octave = osched.octave
        mborders = osched.maximum_borders()
        for z, mb in enumerate(mborders):
            k = 2 * z + 1
            # cell bases
            for i in range(mb, oh - mb, 2):
                for j in range(mb, ow - mb, 2):
                    # cell argmax in cas order: (s, r, c) minor->major c, r, s
                    best = -np.inf
                    bs = br = bc = 0
                    for ds in (0, 1):
                        for di in (0, 1):
                            for dj in (0, 1):
                                v = resp[k + ds, i + di, j + dj]
                                if v > best:
                                    best, bs, br, bc = v, k + ds, i + di, j + dj
                    if best < 0.8 * cfg.thresh:
                        continue
                    if k + 1 == cfg.max_scale - 1 and bs == k + 1:
                        continue
                    nb = resp[bs - 1 : bs + 2, br - 1 : br + 2, bc - 1 : bc + 2]
                    if best < nb.max():
                        continue
                    # iterative subpixel refinement with walking
                    r, c = br, bc
                    s = bs
                    off = np.zeros(3)
                    strength = 0.0
                    newr, newc = r, c
                    for _ in range(cfg.interp_moves):
                        r, c = newr, newc
                        off, strength = _fit_quadrat(resp, s, r, c)
                        if off[1] > 0.6 and r < oh - borders[s]:
                            newr += 1
                        if off[1] < -0.6 and r > borders[s]:
                            newr -= 1
                        if off[2] > 0.6 and c < ow - borders[s]:
                            newc += 1
                        if off[2] < -0.6 and c > borders[s]:
                            newc -= 1
                        if newr == r and newc == c:
                            break
                    if (np.any(np.isnan(off)) or np.any(np.abs(off) > 1.5)
                            or strength < cfg.thresh):
                        continue
                    ns = (cfg.init_lobe + (octave - 1) * cfg.max_scale
                          + (s + off[0]) * 2 * octave) / 3.0
                    ny = octave * (r + off[1])
                    nx = octave * (c + off[2])
                    points.append(_make_point(ii, cfg, nx, ny, ns, strength, o))
                    if len(points) >= cfg.max_pts:
                        return points
    return points


def _make_point(ii, cfg, nx, ny, ns, strength, o):
    """makePoint (surfd.cu:1001-1022)."""
    td = cfg.sampling * cfg.divisor
    temp = int(rz(np.float32(3) * np.float32(ns) + np.float32(0.5)))
    cx = int(rz(np.float32(nx) * np.float32(cfg.sampling) + np.float32(0.5)))
    cy = int(rz(np.float32(ny) * np.float32(cfg.sampling) + np.float32(0.5)))
    x2 = temp // 2
    lap = int(laplace_sign(ii, cx, cy, temp, x2, 2 * x2))
    return OraclePoint(x=nx * td, y=ny * td, scale=1.2 * ns * cfg.divisor,
                       strength=strength, laplace=lap, octave=o)


# ------------------------------------------------------------- descriptors


def wavelet_dy(ii, x, y, size):
    """Haar dy (getWavelet1, surfd.cu:1171-1175)."""
    return (box_sum(ii, x + size, y, x - size, y - size)
            - box_sum(ii, x + size, y + size, x - size, y))


def wavelet_dx(ii, x, y, size):
    """Haar dx (getWavelet2, surfd.cu:1178-1182)."""
    return (box_sum(ii, x + size, y + size, x, y - size)
            - box_sum(ii, x, y + size, x - size, y - size))


def fast_atan2(y, x):
    """dFastAtan2 polynomial approximation (surfd.cu:114-126)."""
    y = np.float32(y); x = np.float32(x)
    absx, absy = np.abs(x), np.abs(y)
    mn, mx = np.minimum(absx, absy), np.maximum(absx, absy)
    with np.errstate(invalid="ignore", divide="ignore"):
        a = (mn / mx).astype(np.float32)
    s = a * a
    r = ((np.float32(-0.0464964749) * s + np.float32(0.15931422)) * s
         - np.float32(0.327622764)) * s * a + a
    r = np.where(absy > absx, np.float32(math.pi / 2) - r, r)
    r = np.where(x < 0, np.float32(math.pi) - r, r)
    r = np.where(y < 0, -r, r)
    return r.astype(np.float32)


def assign_orientation(ii, cfg: SurfConfig, p: OraclePoint) -> float:
    """Windowed 72-bin orientation (assignOrientationApprox,
    surfd.cu:1711-1960)."""
    ih, iw = ii.shape
    if cfg.doubled:
        x, y, scale = 2 * p.x, 2 * p.y, 2 * p.scale
    else:
        x, y, scale = p.x, p.y, p.scale
    pixsi = int(rz(np.float32(2) * np.float32(scale) + np.float32(1.6)))
    step = int(rz(np.float32(scale) + np.float32(0.8)))
    cx, cy = int(rn(np.float32(x))), int(rn(np.float32(y)))

    g = np.arange(-ORADIUS, ORADIUS + 1)
    y1, x1 = np.meshgrid(g, g, indexing="ij")
    xx = cx + x1 * step
    yy = cy + y1 * step
    ok = ((yy + pixsi + 2 < ih) & (yy - pixsi > -1)
          & (xx + pixsi + 2 < iw) & (xx - pixsi > -1))
    distsq = y1 * y1 + x1 * x1
    ok &= distsq < ORADIUS_SQ
    xxc = np.clip(xx, pixsi, iw - pixsi - 2)
    yyc = np.clip(yy, pixsi, ih - pixsi - 2)
    dx = wavelet_dx(ii, xxc, yyc, pixsi).astype(np.float32) * R255
    dy = wavelet_dy(ii, xxc, yyc, pixsi).astype(np.float32) * R255
    mag = np.sqrt(dx * dx + dy * dy).astype(np.float32)
    ok &= mag > 0
    angle = fast_atan2(dy, dx)
    hid = rz((angle + np.float32(math.pi)) / np.float32(SEP_ANGLE)) % NBIN
    psum = (LUT2_SAFE(distsq) * mag).astype(np.float32)

    hist = np.zeros(NBIN, np.int64)
    angsum = np.zeros(NBIN, np.float64)
    part_sums = np.zeros(NBIN, np.float64)
    pas = np.zeros(NBIN + 2 * HWN, np.float64)   # part_angle_sums with wraps
    sel = ok.ravel()
    h_, a_, p_ = hid.ravel()[sel], angle.ravel()[sel], psum.ravel()[sel]
    np.add.at(hist, h_, 1)
    np.add.at(angsum, h_, a_.astype(np.float64))
    np.add.at(part_sums, h_, p_.astype(np.float64))
    np.add.at(pas, h_ + HWN, (a_ * p_).astype(np.float64))
    lo = h_ < HWN
    np.add.at(pas, h_[lo] + HWN + NBIN,
              ((a_[lo] + 2 * np.float32(math.pi)) * p_[lo]).astype(np.float64))
    hi = h_ + HWN >= NBIN
    np.add.at(pas, h_[hi] + HWN - NBIN,
              ((a_[hi] - 2 * np.float32(math.pi)) * p_[hi]).astype(np.float64))

    avg = np.where(hist > 0, angsum / np.maximum(hist, 1), BINS)
    win_sums = np.zeros(NBIN, np.float64)
    win_asums = np.zeros(NBIN, np.float64)
    for i in range(NBIN):
        for j in range(-HWN, HWN + 1):
            k = i + j
            if j == -HWN:
                if k < 0:
                    k += NBIN
                    k1 = (k + 1) % NBIN
                    residual = (BINS[k1] + WINDOW / 2 - avg[i]
                                - (0.0 if BINS[k1] < 0 else 2 * math.pi))
                else:
                    residual = BINS[k + 1] + WINDOW / 2 - avg[i]
                ratio = residual / SEP_ANGLE
                win_sums[i] += ratio * part_sums[k]
                win_asums[i] += ratio * pas[i]
            elif j == HWN:
                if k >= NBIN:
                    k -= NBIN
                    residual = avg[i] + WINDOW / 2 - 2 * math.pi - BINS[k]
                else:
                    residual = avg[i] + WINDOW / 2 - BINS[k]
                ratio = residual / SEP_ANGLE
                win_sums[i] += ratio * part_sums[k]
                win_asums[i] += ratio * pas[i + 2 * HWN]
            else:
                win_asums[i] += pas[k + HWN]
                win_sums[i] += part_sums[k % NBIN]
    best = int(np.argmax(win_sums))
    return float(win_asums[best] / win_sums[best])


def LUT2_SAFE(distsq):
    return LUT1[np.clip(distsq, 0, LUT1.shape[0] - 1)]


def describe(ii, cfg: SurfConfig, p: OraclePoint) -> np.ndarray:
    """Descriptor for one keypoint (describeUR*/describeApprox*,
    surfd.cu:1288-1317, 1984-2015; placeInIndex surfd.cu:1199-1271)."""
    ih, iw = ii.shape
    if cfg.doubled:
        x, y, scale = 2 * p.x, 2 * p.y, np.float32(3.3) * np.float32(p.scale)
    else:
        x, y, scale = p.x, p.y, np.float32(1.65) * np.float32(p.scale)
    x = np.float32(x); y = np.float32(y)
    step = max(int(rn(scale * np.float32(0.5))), 1)
    ix, iy = int(rn(x)), int(rn(y))
    fracx, fracy = np.float32(x - ix), np.float32(y - iy)
    spacing = np.float32(scale * np.float32(cfg.mag_factor))
    iscale = int(rz(scale))
    wofs = np.float32(cfg.desc_wsz * 0.5 - 0.5)
    wsz = cfg.desc_wsz

    if cfg.upright:
        iradius = int(rn(spacing * np.float32((wsz + 1) * 0.5) / np.float32(step)))
        sine, cose = np.float32(0), np.float32(1)
        fracr, fracc = fracy, fracx
    else:
        iradius = int(rn(np.float32(1.4) * spacing * np.float32((wsz + 1) * 0.5)
                         / np.float32(step)))
        sine = np.float32(np.sin(np.float32(p.ori)))
        cose = np.float32(np.cos(np.float32(p.ori)))
        fracr = cose * fracy + sine * fracx
        fracc = -sine * fracy + cose * fracx

    g = np.arange(-iradius, iradius + 1)
    i_, j_ = np.meshgrid(g, g, indexing="ij")
    i_ = i_.ravel(); j_ = j_.ravel()
    stepf = np.float32(step)
    if cfg.upright:
        rpos = (stepf * i_ - fracy) / spacing
        cpos = (stepf * j_ - fracx) / spacing
    else:
        rpos = (stepf * (cose * i_ + sine * j_) - fracr) / spacing
        cpos = (stepf * (-sine * i_ + cose * j_) - fracc) / spacing
    rx = (rpos + wofs).astype(np.float32)
    cx = (cpos + wofs).astype(np.float32)
    ok = (rx > -1) & (rx < wsz) & (cx > -1) & (cx < wsz)
    r = iy + i_ * step
    c = ix + j_ * step
    ok &= (r >= 1 + iscale) & (r < ih - 1 - iscale) \
        & (c >= 1 + iscale) & (c < iw - 1 - iscale)
    rc = np.clip(r, iscale, ih - iscale - 2)
    cc = np.clip(c, iscale, iw - iscale - 2)
    widx = rz((rpos * rpos + cpos * cpos).astype(np.float32))
    weight = LUT2[np.clip(widx, 0, LUT2.shape[0] - 1)].astype(np.float32)
    dxx = weight * wavelet_dx(ii, cc, rc, iscale).astype(np.float32) * R255
    dyy = weight * wavelet_dy(ii, cc, rc, iscale).astype(np.float32) * R255
    if cfg.upright:
        dx, dy = dxx, dyy
    else:
        dx = cose * dxx + sine * dyy
        dy = sine * dxx - cose * dyy

    desc = np.zeros(cfg.nfeatures, np.float64)

    def place(mag1, ori1, mag2, ori2, rxv, cxv, m):
        ri = np.floor(rxv).astype(np.int64)
        ci = np.floor(cxv).astype(np.int64)
        rfrac = rxv - ri
        cfrac = cxv - ci
        for dr, rw1, rw2 in ((0, mag1 * (1 - rfrac), mag2 * (1 - rfrac)),
                             (1, mag1 * rfrac, mag2 * rfrac)):
            rind = ri + dr
            okr = m & (rind >= 0) & (rind < wsz)
            for dc, cwf in ((0, 1 - cfrac), (1, cfrac)):
                cind = ci + dc
                okc = okr & (cind >= 0) & (cind < wsz)
                base = (np.clip(rind, 0, wsz - 1) * wsz * cfg.orient_size
                        + np.clip(cind, 0, wsz - 1) * cfg.orient_size)
                np.add.at(desc, np.where(okc, base + ori1, 0),
                          np.where(okc, (rw1 * cwf).astype(np.float64), 0.0))
                np.add.at(desc, np.where(okc, base + ori2, 0),
                          np.where(okc, (rw2 * cwf).astype(np.float64), 0.0))

    if not cfg.extended:
        place(dx, np.where(dx < 0, 0, 1), dy, np.where(dy < 0, 2, 3), rx, cx, ok)
    else:
        place(dx, np.where(dyy < 0, 0, 1), np.abs(dx),
              np.where(dyy < 0, 2, 3), rx, cx, ok)
        place(dy, np.where(dxx < 0, 4, 5), np.abs(dy),
              np.where(dxx < 0, 6, 7), rx, cx, ok)

    nrm = math.sqrt(float((desc * desc).sum()))
    return (desc / nrm).astype(np.float32) if nrm > 0 else desc.astype(np.float32)


def detect_and_compute(img: np.ndarray, cfg: SurfConfig):
    h, w = img.shape
    ii = integral_image(img, cfg.doubled)
    pyr = response_pyramid(ii, cfg, h, w)
    pts = detect(ii, pyr, cfg, h, w)
    if not cfg.upright:
        for p in pts:
            p.ori = assign_orientation(ii, cfg, p)
    descs = np.stack([describe(ii, cfg, p) for p in pts]) if pts else \
        np.zeros((0, cfg.nfeatures), np.float32)
    return pts, descs


# ------------------------------------------------------------------ match


def match(desc1: np.ndarray, desc2: np.ndarray):
    """Brute-force best/second-best cosine matching (findMaxCorr semantics,
    surfd.cu:2610-2669): one-directional set1->set2, ambiguity =
    second / (best + 1e-6)."""
    scores = desc1.astype(np.float64) @ desc2.astype(np.float64).T
    order = np.argsort(-scores, axis=1)
    best = order[:, 0]
    best_s = scores[np.arange(len(desc1)), best]
    sec_s = scores[np.arange(len(desc1)), order[:, 1]] if desc2.shape[0] > 1 \
        else np.zeros(len(desc1))
    return best, best_s, sec_s / (best_s + 1e-6)
