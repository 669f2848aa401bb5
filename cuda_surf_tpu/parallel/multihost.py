"""Multi-process / multi-host runtime entry.

The reference has no communication layer at all (single CUDA device,
cuda_utils.h:41-67); this module is the multi-host half of the
distribution backbone: process-group initialization via
`jax.distributed.initialize`, a global mesh over every device of every
process, and helpers to build global (process-spanning) arrays from
host-local shards.  Within one host the collectives ride NVLink; across
hosts XLA routes the same collectives over the network (NCCL under
XLA) — the program needs no NCCL/MPI code of its own.

Environment contract (set by the launcher, one process per host):

  SURF_COORDINATOR   host:port of process 0 (required to enable)
  SURF_NUM_PROCESSES total process count
  SURF_PROCESS_ID    this process's rank

JAX's own cluster autodetection keeps working — `initialize_from_env`
only passes explicit values when the SURF_* variables are present,
otherwise it defers to JAX's own autodetection.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def multiprocess_env() -> bool:
    """True when a multi-process launch is configured in the env."""
    return "SURF_COORDINATOR" in os.environ


def initialize_from_env(timeout_s: int = 60) -> bool:
    """Initialize the JAX process group from the environment.

    Returns True if running multi-process (after initialization), False
    for the ordinary single-process case.  Idempotent.
    """
    global _initialized
    if _initialized:
        return True
    if not multiprocess_env():
        return False
    coord = os.environ["SURF_COORDINATOR"]
    missing = [k for k in ("SURF_NUM_PROCESSES", "SURF_PROCESS_ID")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            "SURF_COORDINATOR is set but the launch contract is "
            f"incomplete: missing {', '.join(missing)} (set all three "
            "SURF_* variables, or none to defer to JAX autodetection)")
    nproc = int(os.environ["SURF_NUM_PROCESSES"])
    pid = int(os.environ["SURF_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid,
        initialization_timeout=timeout_s)
    _initialized = True
    return True


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def global_mesh(axis_name: str = "frames") -> Mesh:
    """1-D mesh over every device in the slice (all processes)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def global_batch(host_local: np.ndarray, mesh: Mesh,
                 axis_name: str = "frames"):
    """Build a global array sharded on `axis_name` from each process's
    host-local batch (leading-axis concatenation in process order).

    Single-process this is just a device_put; multi-process it uses
    `jax.make_array_from_process_local_data`, the standard multi-host
    input pipeline: every process feeds only the shard(s) its local
    devices own.
    """
    sharding = NamedSharding(mesh, P(axis_name))
    if jax.process_count() == 1:
        return jax.device_put(host_local, sharding)
    global_shape = (host_local.shape[0] * jax.process_count(),
                    *host_local.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, host_local, global_shape)


def all_processes_value(x) -> np.ndarray:
    """Fetch a replicated global scalar/array to every host (helper for
    logging/metrics on multi-host runs)."""
    return np.asarray(jax.device_get(x))
