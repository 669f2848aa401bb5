"""Box-filter Hessian determinant response pyramid.

JAX re-derivation of calcHessianMultiConst + cuCalcHessianMulti
(surfd.cu:445-481, 2829-2894) and the cross-octave halfImage reuse
(surf.cpp:253-258).  Instead of per-pixel gathers from constant-memory
parameters, every box-sum corner becomes a *strided slice* of the integral
image (stride = the scale's sampling delta), so the whole response map is
a fused elementwise expression over 32 slices — no gather, no scatter,
bandwidth-bound, which is the roofline for this stage.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..config import SurfConfig, ScaleParams


def response_pyramid(ii: jnp.ndarray, cfg: SurfConfig, h: int, w: int):
    """-> list over octaves of (max_scale, Ho, Wo) float32 response maps.

    Out-of-border entries are zero, matching the reference's steady-state
    zeroed omem buffer (surf.cpp:347-348).  Scales 0-1 of octaves > 0 are
    seeded by 2x decimation of scales max_scale-3 / max_scale-1 of the
    previous octave (halfImage, surfd.cu:321-331).
    """
    shapes = cfg.octave_shapes(h, w)
    sched = cfg.hessian_schedule(h, w)
    pyr = []
    for o in range(cfg.noctaves):
        oh, ow = shapes[o]
        layers = []
        if o > 0:
            layers.append(pyr[o - 1][cfg.max_scale - 3, : 2 * oh : 2, : 2 * ow : 2])
            layers.append(pyr[o - 1][cfg.max_scale - 1, : 2 * oh : 2, : 2 * ow : 2])
        phases = {}
        for sp in sched[o].scales:
            layers.append(_response_layer(ii, sp, oh, ow, phases))
        pyr.append(jnp.stack(layers))
    return pyr


def _response_layer(ii: jnp.ndarray, sp: ScaleParams, oh: int, ow: int,
                    phases: dict):
    """One scale's response map via phase-decimated box sums.

    The integral image is decimated once per needed (row, col) phase mod
    delta — `phases` caches these strided slices across the octave's
    scales — and every box-sum corner becomes a unit-stride slice of a
    phase plane, which XLA fuses into the elementwise determinant
    computation.
    """
    b1, d = sp.border1, sp.delta
    ny, nx = oh - 2 * b1, ow - 2 * b1
    if ny <= 0 or nx <= 0:
        return jnp.zeros((oh, ow), jnp.float32)
    ih, iw = ii.shape

    def corner(dy: int, dx: int):
        # ii[d*(b1+y) + dy, d*(b1+x) + dx] for the full (ny, nx) grid.
        p, q = dy % d, dx % d
        if (p, q) not in phases:
            phases[(p, q)] = lax.slice(ii, (p, q), (ih, iw), (d, d))
        ph = phases[(p, q)]
        y0, x0 = b1 + dy // d, b1 + dx // d
        return lax.slice(ph, (y0, x0), (y0 + ny, x0 + nx))

    def sbox(x1: int, y1: int, x2: int, y2: int):
        # getSum with static offsets relative to the grid centre.
        return (corner(y1 + 1, x1 + 1) + corner(y2, x2)
                - corner(y2, x1 + 1) - corner(y1 + 1, x2))

    m, x2, x3, x4 = sp.mask_size, sp.x2, sp.x3, sp.x4
    dxx = (sbox(m + x2, x3, -m - x2, -x3) - 3 * sbox(x2, x3, -x2, -x3)
           ).astype(jnp.float32)
    dyy = (sbox(x3, m + x2, -x3, -m - x2) - 3 * sbox(x3, x2, -x3, -x2)
           ).astype(jnp.float32)
    dxy = jnp.float32(0.6) * (
        sbox(x4, 0, 0, -x4) + sbox(0, x4, -x4, 0)
        - sbox(x4, x4, 0, 0) - sbox(0, 0, -x4, -x4)).astype(jnp.float32)
    r = jnp.float32(0.003921568627)
    det = r * r * (dxx * dyy - dxy * dxy) * jnp.float32(sp.norm)
    return jnp.zeros((oh, ow), jnp.float32).at[b1:oh - b1, b1:ow - b1].set(det)
