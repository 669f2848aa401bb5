"""SURF frontend pipeline driver.

JAX equivalent of surf::Surfor (surf.cpp:60-428): owns nothing —
the pipeline is a pure jitted function of (image, static config).  The
reference's buffer caching (imem/omem reuse, surf.cpp:222-231) is
subsumed by XLA's compilation cache + buffer donation; its constant-memory
uploads are compile-time constants baked in through `SurfConfig`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .config import SurfConfig
from .types import Keypoints, Matches, compact
from .ops.integral import integral_image
from .ops.hessian import response_pyramid
from .ops.extrema import detect
from .ops.orientation import assign_orientations
from .ops.descriptor import describe
from .ops.matcher import match_keypoints


def _detect_frame(image: jnp.ndarray, cfg: SurfConfig):
    """Integral image + response pyramid (+ schedule) for one frame."""
    h, w = image.shape
    ii = integral_image(image, cfg.doubled)
    sched = cfg.hessian_schedule(h, w)
    pyr = response_pyramid(ii, cfg, h, w)
    return ii, pyr, sched


def _make_keypoints(ii, cand, cfg: SurfConfig, nframes: int = 1,
                    slab: int = 0, frame_hw=None):
    """Compaction + makePoint (surfd.cu:1001-1022): scale octave-space
    coords to image space, Laplacian sign on the integral image.

    `nframes=B`: frame-stacked mode — cand holds the union of B
    frames' candidates (with `frame` ids), `ii` stacks the B integral
    images vertically at `slab`-row offsets, and ONE compaction /
    Laplacian take serves all frames (returns an extra frame-id
    array).  Laplacian corner clamps run frame-locally on `frame_hw`.
    NOTE: the union capacity is B*max_pts; a frame with more than
    max_pts valid keypoints truncates exactly like the single-frame
    path, but its overflow can additionally displace later frames'
    slots when the union total exceeds capacity."""
    stacked = frame_hw is not None
    if stacked:
        count, valid, nx, ny, ns, strength, octave, fid = compact(
            cand["valid"], cfg.max_pts * nframes, cand["nx"], cand["ny"],
            cand["ns"], cand["strength"], cand["octave"], cand["frame"])
    else:
        count, valid, nx, ny, ns, strength, octave = compact(
            cand["valid"], cfg.max_pts, cand["nx"], cand["ny"],
            cand["ns"], cand["strength"], cand["octave"])
        fid = None

    td = jnp.float32(cfg.sampling * cfg.divisor)
    x = nx * td
    y = ny * td
    scale = jnp.float32(1.2) * ns * jnp.float32(cfg.divisor)
    temp = jnp.trunc(jnp.float32(3.0) * ns + jnp.float32(0.5)).astype(jnp.int32)
    cx = jnp.trunc(nx * jnp.float32(cfg.sampling) + jnp.float32(0.5)).astype(jnp.int32)
    cy = jnp.trunc(ny * jnp.float32(cfg.sampling) + jnp.float32(0.5)).astype(jnp.int32)
    x2 = temp // 2
    x3 = 2 * x2

    # The four Laplacian box sums are 16 integral-image corner reads,
    # gathered in ONE flat take instead of a box_sum() call (4 gathers)
    # per box (bit-identical: per-axis index clamping replicated, int32
    # adds reassociate exactly).
    if stacked:
        ih_i, iw_i = frame_hw
        rb = fid * slab
    else:
        ih_i, iw_i = ii.shape
        rb = 0
    iif = ii.reshape(-1)

    def corner(xx, yy):
        # replicate jnp advanced-indexing semantics exactly: negative
        # indices wrap once, then clamp to the valid range (frame-local
        # in stacked mode, then offset to the frame's slab)
        xx = jnp.clip(jnp.where(xx < 0, xx + iw_i, xx), 0, iw_i - 1)
        yy = jnp.clip(jnp.where(yy < 0, yy + ih_i, yy), 0, ih_i - 1)
        return (rb + yy) * iw_i + xx

    def box_corners(x1, y1, x2_, y2_):
        # getSum corners (surfd.cu:334-343): +(y1+1,x1+1) +(y2,x2)
        # -(y2,x1+1) -(y1+1,x2)
        return [corner(x1 + 1, y1 + 1), corner(x2_, y2_),
                corner(x1 + 1, y2_), corner(x2_, y1 + 1)]

    boxes = (box_corners(cx + temp + x2, cy + x3, cx - temp - x2, cy - x3)
             + box_corners(cx + x2, cy + x3, cx - x2, cy - x3)
             + box_corners(cx + x3, cy + temp + x2, cx - x3, cy - temp - x2)
             + box_corners(cx + x3, cy + x2, cx - x3, cy - x2))
    vals = jnp.take(iif, jnp.stack(boxes).reshape(-1)).reshape(16, -1)
    b = vals[0::4] + vals[1::4] - vals[2::4] - vals[3::4]   # (4, K)
    lxx = b[0] - 3 * b[1]
    lyy = b[2] - 3 * b[3]
    laplace = jnp.where(lxx + lyy > 0, 1, -1).astype(jnp.int32)
    if stacked:
        return count, valid, x, y, scale, strength, laplace, octave, fid
    return count, valid, x, y, scale, strength, laplace, octave


def detect_and_compute(image: jnp.ndarray, cfg: SurfConfig,
                       compute_descriptors: bool = True):
    """uint8 (H, W) -> (Keypoints, (max_pts, nfeatures) descriptors).

    Pipeline mirror of Surfor::detectAndCompute (surf.cpp:205-355):
    integral image -> per-octave response maps (with cross-octave
    decimation reuse) -> fused NMS+interp -> orientation (unless upright)
    -> descriptors -> L2 normalize.
    """
    ii, pyr, sched = _detect_frame(image, cfg)
    cand = detect(pyr, sched, cfg)
    count, valid, x, y, scale, strength, laplace, octave = \
        _make_keypoints(ii, cand, cfg)
    # Describe from the float32 keypoint values as returned: without the
    # barrier XLA may fuse makePoint's products into the sampling-offset
    # arithmetic (an FMA keeps extra bits), moving a sample across a bin
    # or weight boundary relative to the batched path and the oracle.
    x, y, scale = jax.lax.optimization_barrier((x, y, scale))

    ori = jnp.zeros_like(x)
    if compute_descriptors and not cfg.upright:
        ori = assign_orientations(ii, cfg, x, y, scale, valid)
        ori = jnp.where(valid, ori, 0.0)

    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=ori, octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, jnp.zeros((cfg.max_pts, cfg.nfeatures), jnp.float32)
    desc = describe(ii, cfg, x, y, scale, ori, valid)
    desc = jnp.where(valid[:, None], desc, 0.0)
    return kps, desc


def detect_and_compute_batch(images: jnp.ndarray, cfg: SurfConfig,
                             compute_descriptors: bool = True):
    """uint8 (B, H, W) -> (Keypoints with (B, max_pts) fields,
    (B, max_pts, nfeatures) descriptors) — the throughput formulation
    of the pipeline (BASELINE.md's frames/sec/chip metric).

    The per-frame stages that are fixed-overhead bound (candidate
    compaction, subpixel walk, makePoint: dozens of small kernels on
    (cap,) vectors) run ONCE over the union of the B frames' candidates,
    and one descriptor call serves all B frames' keypoints over their
    integral images stacked vertically at 32-aligned slab offsets
    (frame-local border semantics preserved via per-keypoint row
    bases).  The pyramids stay per-frame inside the one jitted program
    (their cost is area-proportional, not overhead-bound).

    Rotated mode (upright=False) runs lax.map of the single-frame
    pipeline (the orientation stage is not frame-stacked).
    """
    B, h, w = images.shape
    if not cfg.upright and compute_descriptors:
        return jax.lax.map(
            lambda im: detect_and_compute(im, cfg, compute_descriptors),
            images)

    iis, pyrs = [], []
    for f in range(B):  # per-frame pyramids, one program
        ii_f, pyr_f, sched = _detect_frame(images[f], cfg)
        iis.append(ii_f)
        pyrs.append(pyr_f)
    ii = jnp.stack(iis)
    pyr_b = [jnp.stack([pyrs[f][o] for f in range(B)])
             for o in range(cfg.noctaves)]

    # FRAME-STACKED keypoint stages: the compaction, interpolation walk
    # and makePoint/Laplacian run ONCE over the union of all B frames'
    # candidates instead of per frame.  The union is frame-major and
    # stable, so each frame's keypoints form a contiguous run
    # redistributed to the (B, max_pts) layout by one gather.
    cand = detect(pyr_b, sched, cfg, nframes=B)
    ih, iw = ii.shape[1], ii.shape[2]
    hs = -(-ih // 32) * 32  # 32-aligned slab stride
    ii_stack = jnp.pad(
        ii, ((0, 0), (0, hs - ih), (0, 0))).reshape(B * hs, iw)
    (count_u, valid_u, x_u, y_u, scale_u, strength_u, laplace_u,
     octave_u, fid) = _make_keypoints(ii_stack, cand, cfg,
                                      nframes=B, slab=hs,
                                      frame_hw=(ih, iw))

    capU = B * cfg.max_pts
    fr = jnp.arange(B, dtype=jnp.int32)
    inframe = (fid[None, :] == fr[:, None]) & valid_u[None, :]
    cnt_f = jnp.sum(inframe.astype(jnp.int32), axis=1)        # (B,)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(cnt_f)[:-1]])
    jj = jnp.arange(cfg.max_pts, dtype=jnp.int32)
    valid_o = jj[None, :] < cnt_f[:, None]                    # (B, max)
    idxf = jnp.where(valid_o,
                     jnp.minimum(starts[:, None] + jj[None, :], capU - 1),
                     0).reshape(-1)

    def redist(a):
        v = jnp.take(a, idxf).reshape(B, cfg.max_pts)
        return jnp.where(valid_o, v, jnp.zeros((), a.dtype))

    x, y, scale, strength = (redist(x_u), redist(y_u), redist(scale_u),
                             redist(strength_u))
    laplace, octave = redist(laplace_u), redist(octave_u)
    valid, count = valid_o, cnt_f

    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=jnp.zeros_like(x), octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, jnp.zeros((B, cfg.max_pts, cfg.nfeatures), jnp.float32)

    # frame-stacked describe: all B frames' keypoints in one call
    row_base = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * hs, cfg.max_pts)
    flat = lambda a: a.reshape(B * cfg.max_pts)
    d = describe(ii_stack, cfg, flat(x), flat(y), flat(scale),
                 jnp.zeros((B * cfg.max_pts,), jnp.float32),
                 flat(valid), row_base=row_base, frame_hw=(ih, iw))
    d = jnp.where(flat(valid)[:, None], d, 0.0)
    return kps, d.reshape(B, cfg.max_pts, cfg.nfeatures)


class Surf:
    """Convenience stateful wrapper holding jitted closures per config
    (the `Surfor` role, surf.h:20-62)."""

    def __init__(self, cfg: SurfConfig | None = None, **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        self._detect = jax.jit(
            functools.partial(detect_and_compute, cfg=self.cfg))
        self._match = jax.jit(match_keypoints)

    def detect_and_compute(self, image):
        return self._detect(jnp.asarray(image, jnp.uint8))

    def match(self, kp1, desc1, kp2, desc2) -> Matches:
        return self._match(kp1, desc1, kp2, desc2)
