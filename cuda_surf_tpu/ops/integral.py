"""Integral image (JAX re-derivation of surfd.cu:129-318).

The reference builds the zero-padded int32 integral image with per-row /
per-column scan kernels (integralRow/integralCol) and a 6-launch unroll-4
blocked scan for the 2x-upsampled variant (cuIntegralDoubleU4,
surfd.cu:2707-2772).  Here the same prefix sums are two int32
`jnp.cumsum` scans, which XLA lowers to native memory-bound scan
kernels; they are exact for any image that fits the int32 range.
"""

from __future__ import annotations

import jax.numpy as jnp


def integral_image(img: jnp.ndarray, doubled: bool = False) -> jnp.ndarray:
    """uint8 (H, W) -> int32 zero-padded integral image.

    I[y, x] = sum(img[:y, :x]); row 0 / col 0 are zero (the (+1,+1) write
    offset of integralRow, surfd.cu:135-138).  With `doubled`, the source
    is 2x bilinearly upsampled with round-half-even first
    (integralDoubleRow0U2 semantics, surfd.cu:186-205), output
    (2H-1+1 x 2W-1+1) - 1 => (2H-1, 2W-1) source grid.
    """
    src = img.astype(jnp.int32)
    if doubled:
        h, w = src.shape
        up = jnp.zeros((2 * h - 1, 2 * w - 1), jnp.int32)
        up = up.at[0::2, 0::2].set(src)
        up = up.at[0::2, 1::2].set(_rn((src[:, :-1] + src[:, 1:]) * jnp.float32(0.5)))
        up = up.at[1::2, 0::2].set(_rn((src[:-1, :] + src[1:, :]) * jnp.float32(0.5)))
        up = up.at[1::2, 1::2].set(_rn(
            (src[:-1, :-1] + src[:-1, 1:] + src[1:, :-1] + src[1:, 1:])
            * jnp.float32(0.25)))
        src = up
    h, w = src.shape
    ii = jnp.cumsum(jnp.cumsum(src, axis=0, dtype=jnp.int32), axis=1,
                    dtype=jnp.int32)
    return jnp.zeros((h + 1, w + 1), jnp.int32).at[1:, 1:].set(ii)


def _rn(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.round(x).astype(jnp.int32)


def box_sum(ii: jnp.ndarray, x1, y1, x2, y2):
    """Inclusive rectangle sum over cols [x2..x1], rows [y2..y1]
    (getSum, surfd.cu:334-343).  Index args may be arrays (gather form)."""
    return ii[y1 + 1, x1 + 1] + ii[y2, x2] - ii[y2, x1 + 1] - ii[y1 + 1, x2]


def wavelet_dy(ii, x, y, size):
    """Haar wavelet dy response (getWavelet1, surfd.cu:1171-1175)."""
    return (box_sum(ii, x + size, y, x - size, y - size)
            - box_sum(ii, x + size, y + size, x - size, y))


def wavelet_dx(ii, x, y, size):
    """Haar wavelet dx response (getWavelet2, surfd.cu:1178-1182)."""
    return (box_sum(ii, x + size, y + size, x, y - size)
            - box_sum(ii, x, y + size, x - size, y - size))
