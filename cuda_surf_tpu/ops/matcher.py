"""Brute-force descriptor matching.

JAX re-derivation of findMaxCorr (surfd.cu:2535-2671).  The CUDA kernel
hand-tiles a 64-wide dot-product cross-matrix through skewed shared
memory with best/second-best tracking; here that structure is one
`D1 @ D2.T` matmul followed by masked max / second-max reductions.
Semantics preserved: one-directional set1 -> set2 nearest neighbour,
scores are cosine similarities of L2-normalized descriptors, ambiguity
= second_best / (best + 1e-6) (surfd.cu:2665-2669); no ratio-test
rejection is applied.

The cross-matrix runs at `Precision.HIGHEST` (IEEE float32 products):
a default float32 matmul may run in TF32 on the GPU (~1e-3 relative),
enough to flip near-tie matches and ambiguities.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..types import Keypoints, Matches


def cross_scores(desc1: jnp.ndarray, desc2: jnp.ndarray) -> jnp.ndarray:
    """(N1, D) x (N2, D) -> (N1, N2) float32 cosine scores at full
    float32 precision."""
    return jnp.dot(desc1, desc2.T, preferred_element_type=jnp.float32,
                   precision=lax.Precision.HIGHEST)


def match(desc1: jnp.ndarray, valid1: jnp.ndarray,
          desc2: jnp.ndarray, valid2: jnp.ndarray,
          x2: jnp.ndarray, y2: jnp.ndarray,
          scores: jnp.ndarray | None = None) -> Matches:
    neg = jnp.float32(-1e30)
    if scores is None:
        scores = cross_scores(desc1, desc2)
    scores = jnp.where(valid2[None, :], scores, neg)
    # Best/second-best via two masked max passes over the matmul output
    # (the reference tracks exactly max + second-max per point,
    # surfd.cu:2610-2626).
    best = jnp.max(scores, axis=1)
    index = jnp.argmax(scores, axis=1).astype(jnp.int32)
    cols = lax.broadcasted_iota(jnp.int32, scores.shape, 1)
    second = jnp.max(jnp.where(cols == index[:, None], neg, scores), axis=1)
    return Matches(
        score=best,
        index=index,
        match_x=x2[index],
        match_y=y2[index],
        ambiguity=jnp.where(second > neg,
                            second / (best + jnp.float32(1e-6)), 0.0),
        valid=valid1 & (best > neg),
    )


def match_keypoints(kp1: Keypoints, desc1: jnp.ndarray,
                    kp2: Keypoints, desc2: jnp.ndarray,
                    cross_check: bool = False) -> Matches:
    """One-directional set1 -> set2 matching (the reference semantics).

    With `cross_check`, matches that are not mutual nearest neighbours
    are marked invalid (the symmetric filter the reference leaves to
    its caller) — one extra masked-argmax over the same score matrix.
    """
    scores = cross_scores(desc1, desc2)
    m = match(desc1, kp1.valid, desc2, kp2.valid, kp2.x, kp2.y,
              scores=scores)
    if not cross_check:
        return m
    neg = jnp.float32(-1e30)
    # reuse the forward cross-matrix: the backward argmax only masks
    # along the other axis, no second matmul needed
    scores = jnp.where(kp1.valid[:, None], scores, neg)
    back = jnp.argmax(scores, axis=0).astype(jnp.int32)   # (N2,)
    mutual = back[m.index] == jnp.arange(m.index.shape[0], dtype=jnp.int32)
    return m._replace(valid=m.valid & mutual)
