"""Device-mesh construction and sharding helpers.

The reference is single-device with no communication layer (SURVEY.md
section 2.5); this module is the distribution backbone this build adds:
a named 1-D mesh over the devices, with frame batches sharded over
the `frames` axis (data parallelism for frontend throughput) and bundle-
adjustment blocks sharded over the same axis with `psum`/`reduce_scatter`
reduction of the Schur camera system (ba/distributed.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frames"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (frame/batch) axis across the mesh."""
    return NamedSharding(mesh, P(FRAME_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
