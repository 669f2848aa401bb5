"""Core data model: fixed-capacity struct-of-arrays pytrees.

JAX replacement of the reference's array-of-structs `SurfPoint` /
`SurfData` (surf_structures.h:7-41).  XLA wants static shapes and SoA
layout, so keypoint sets are padded to a static capacity with a validity
mask and an explicit count instead of the reference's atomicInc-compacted
dynamic arrays (surfd.cu:662-672).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class Keypoints:
    """Fixed-capacity SURF keypoint set.

    Fields mirror SurfPoint (surf_structures.h:7-31) minus the match slots,
    which live in :class:`Matches`.
    """

    def __init__(self, x, y, scale, strength, laplace, ori, octave, valid, count):
        self.x = x                  # (N,) f32, image-space x
        self.y = y                  # (N,) f32
        self.scale = scale          # (N,) f32 (already includes the 1.2 factor)
        self.strength = strength    # (N,) f32 interpolated det-of-Hessian peak
        self.laplace = laplace      # (N,) i32 sign of Laplacian (+1/-1)
        self.ori = ori              # (N,) f32 orientation (0 when upright)
        self.octave = octave        # (N,) i32
        self.valid = valid          # (N,) bool
        self.count = count          # () i32 number of valid points

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @staticmethod
    def empty(capacity: int) -> "Keypoints":
        z = jnp.zeros((capacity,), jnp.float32)
        return Keypoints(
            x=z - 1.0, y=z - 1.0, scale=z + 1.0, strength=z,
            laplace=jnp.ones((capacity,), jnp.int32), ori=z,
            octave=jnp.zeros((capacity,), jnp.int32),
            valid=jnp.zeros((capacity,), bool), count=jnp.int32(0),
        )

    def tree_flatten(self):
        leaves = (self.x, self.y, self.scale, self.strength, self.laplace,
                  self.ori, self.octave, self.valid, self.count)
        return leaves, None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    def __repr__(self):
        return f"Keypoints(capacity={self.capacity})"


class Matches(NamedTuple):
    """One-directional nearest-neighbour assignment set1 -> set2.

    Mirrors the match slots of SurfPoint written by findMaxCorr
    (surfd.cu:2665-2669): cosine score, matched index, matched point
    coordinates, and second-best/best ambiguity ratio.
    """

    score: jax.Array      # (N1,) f32 best cosine similarity
    index: jax.Array      # (N1,) i32 index into set2
    match_x: jax.Array    # (N1,) f32
    match_y: jax.Array    # (N1,) f32
    ambiguity: jax.Array  # (N1,) f32 second_best / (best + 1e-6)
    valid: jax.Array      # (N1,) bool


def compact(mask: jax.Array, capacity: int, *arrays):
    """Stream-compact `arrays` rows where `mask` is set into fixed-size
    buffers of length `capacity` (valid-first, stable order; invalid
    slots are zero).

    Replacement for atomic append: gather-based — the i-th output is
    located with a vectorized search over the mask's prefix sum
    (`capacity` searches, in place of a scatter over the full input,
    here millions of pyramid cells).  Returns (count, valid,
    *compacted).
    """
    mask = mask.reshape(-1)
    n = mask.shape[0]
    slots = jnp.arange(capacity, dtype=jnp.int32)
    if n >= (1 << 17):
        # three-level: locate the i-th set bit's 128-element block with
        # two compare-and-count reductions (superblock, then block via
        # one row gather) instead of searchsorted's serial binary-search
        # gather rounds, then find the in-block position from a
        # row-gathered lane prefix sum
        B = 128
        nb = -(-n // B)
        mp = jnp.pad(mask, (0, nb * B - n)).reshape(nb, B)
        bcs = jnp.cumsum(jnp.sum(mp, axis=1, dtype=jnp.int32))
        count = jnp.minimum(bcs[-1], capacity)
        S = 128
        nsb = -(-nb // S)
        bcs_p = jnp.pad(bcs, (0, nsb * S - nb), mode="edge").reshape(nsb, S)
        want = (slots + 1)[:, None]
        sb = jnp.sum((bcs_p[:, -1][None, :] < want).astype(jnp.int32),
                     axis=1)                             # (capacity,)
        rows_b = jnp.take(bcs_p, sb, axis=0)             # (capacity, S)
        blk = sb * S + jnp.sum((rows_b < want).astype(jnp.int32), axis=1)
        blk = jnp.minimum(blk, nb - 1)
        base = jnp.where(blk > 0, jnp.take(bcs, jnp.maximum(blk - 1, 0)), 0)
        rows = jnp.take(mp, blk, axis=0)                 # (capacity, B)
        within = jnp.cumsum(rows.astype(jnp.int32), axis=1)
        pos = jnp.argmax((within == (slots + 1 - base)[:, None]) & rows,
                         axis=1)
        idx = (blk * B + pos).astype(jnp.int32)
    else:
        cs = jnp.cumsum(mask.astype(jnp.int32))
        count = jnp.minimum(cs[-1], capacity) if n else jnp.int32(0)
        idx = jnp.searchsorted(cs, slots + 1).astype(jnp.int32)
    out_valid = slots < count
    idx = jnp.where(out_valid, idx, 0)

    # Fast path: when every array is 1-D with 4-byte (or bool) elements,
    # bitcast-pack them into one (n, A) uint32 matrix and gather ALL of
    # them with a single row take — each separate jnp.take is its own
    # gather kernel, so compacting 7 arrays costs 7 kernels otherwise.
    from jax import lax as _lax

    def _pack(a):
        if a.dtype == jnp.bool_:
            return a.astype(jnp.uint32)
        if a.dtype.itemsize == 4:
            return _lax.bitcast_convert_type(a, jnp.uint32)
        return None

    if len(arrays) >= 2 and all(a.ndim == 1 for a in arrays):
        cols = [_pack(a.reshape(-1)) for a in arrays]
        if all(c is not None for c in cols):
            packed = jnp.stack(cols, axis=1)               # (n, A)
            took = jnp.take(packed, idx, axis=0)           # (cap, A)
            took = jnp.where(out_valid[:, None], took, 0)
            outs = []
            for j, a in enumerate(arrays):
                v = took[:, j]
                outs.append(v != 0 if a.dtype == jnp.bool_
                            else _lax.bitcast_convert_type(v, a.dtype))
            return count, out_valid, *outs

    outs = []
    for a in arrays:
        a = a.reshape(n, *a.shape[1:]) if a.ndim > 1 else a.reshape(-1)
        v = jnp.take(a, idx, axis=0)
        zero = jnp.zeros((), a.dtype)
        mask_nd = out_valid.reshape((capacity,) + (1,) * (a.ndim - 1))
        outs.append(jnp.where(mask_nd, v, zero))
    return count, out_valid, *outs
