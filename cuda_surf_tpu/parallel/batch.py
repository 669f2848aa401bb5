"""Data-parallel frame-batch frontend.

The reference processes one frame per call on one device; this build
scales frontend throughput by sharding a frame batch across the device
mesh (BASELINE.md: "frames sharded across chips for throughput").  The
per-frame pipeline is pure, so data parallelism needs zero cross-device
communication: under `shard_map` each device runs its own frames end
to end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SurfConfig
from ..frontend import detect_and_compute
from ..ops.matcher import match_keypoints
from .mesh import make_mesh


class BatchSurf:
    """Batched SURF frontend over a device mesh.

    detect_and_compute takes (B, H, W) uint8 with B a multiple of the
    mesh size and returns batched Keypoints / (B, max_pts, nfeatures)
    descriptors, sharded over the frame axis.
    """

    def __init__(self, cfg: SurfConfig | None = None, mesh=None, **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        self.mesh = mesh if mesh is not None else make_mesh()

        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        axis = self.mesh.axis_names[0]

        # shard_map + lax.map: each device loops over its local frames
        # with exactly the single-frame program (vmap against lax.map is
        # an open measurement, ROADMAP Queue 1).
        def _local(images):
            return jax.lax.map(
                lambda im: detect_and_compute(im, self.cfg), images)

        self._detect = jax.jit(shard_map(
            _local, mesh=self.mesh, in_specs=P(axis),
            out_specs=P(axis), check_vma=False))

        @jax.jit
        def _match(kp1, d1, kp2, d2):
            return jax.lax.map(lambda t: match_keypoints(*t),
                               (kp1, d1, kp2, d2))

        self._match = _match

    def detect_and_compute(self, images):
        images = jnp.asarray(images, jnp.uint8)
        if images.shape[0] % self.mesh.size:
            raise ValueError(
                f"batch {images.shape[0]} not divisible by mesh size "
                f"{self.mesh.size}")
        return self._detect(images)

    def match(self, kp1, d1, kp2, d2):
        """Batched one-directional matching of corresponding frame pairs."""
        return self._match(kp1, d1, kp2, d2)
