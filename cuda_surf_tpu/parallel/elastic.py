"""Failure detection and elastic recovery for long-running jobs.

The reference aborts the process on any device error (`CHECK`,
the reference's cuda_utils.h:18-25) and runs single-GPU, so it needs no
recovery story.  Long multi-host runs (distributed BA, full-sequence
SLAM) do — SURVEY.md section 5 row 3.  The accelerator failure model
shapes the design: a lost host or a wedged collective takes the whole process
group down (or hangs it), and the recovery path is *external restart +
resume from the newest complete checkpoint*, not in-place retry of a
device call.  This module provides the three pieces of that story:

  - `Heartbeat` — a daemon thread that atomically publishes
    `{step, time, pid, process_index}` to a file at a fixed cadence.
    An external watchdog (or another host) reads it to detect a dead
    or wedged process; `Heartbeat.stalled()` exposes the same check
    in-process (a step that stopped beating past `stall_timeout`).
  - `CheckpointDir` — atomic (write-temp + rename), step-numbered
    checkpoints with newest-complete discovery and pruning.  A torn
    write (process killed mid-checkpoint) is invisible: the temp file
    never gets renamed, so resume always sees a complete snapshot.
  - `run_elastic` — a step-loop driver: checkpoint every N steps,
    beat every step, and on a step failure restore the newest
    checkpoint and continue (bounded retries).  In-process restart
    covers transient failures (preemption notice, OOM after memory
    pressure, flaky IO); process-fatal failures are covered by simply
    re-running the same `run_elastic` call after the external
    restart — it resumes from the same checkpoints.

Checkpoint payloads are pytrees of arrays (saved with numpy's npz, the
same dependency-free format as slam/checkpoint.py).  On multi-host
runs, every process checkpoints only on process 0 by default (the
state is replicated or host-local — pass `all_processes=True` for
host-local state like data-loader cursors).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

try:  # optional: process_index for multi-host labeling
    import jax
except Exception:  # pragma: no cover
    jax = None


def _process_index() -> int:
    if jax is None:
        return 0
    try:
        return jax.process_index()
    except Exception:
        return 0


class Heartbeat:
    """Atomically publishes liveness+progress to `path` every
    `interval` seconds from a daemon thread; `beat(step)` records
    progress from the step loop."""

    def __init__(self, path: str, interval: float = 5.0,
                 stall_timeout: float = 120.0):
        self.path = path
        self.interval = interval
        self.stall_timeout = stall_timeout
        self._step = -1
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- publishing ----------------------------------------------------
    def _write(self):
        payload = {
            "step": self._step,
            "time": time.time(),
            "monotonic": time.monotonic(),
            "pid": os.getpid(),
            "process_index": _process_index(),
        }
        # thread-unique tmp: stop() writes from the main thread after a
        # join timeout, possibly while a wedged daemon thread is still
        # inside its own _write — a shared tmp name would race the
        # os.replace and raise FileNotFoundError out of stop()
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)  # atomic on POSIX

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self._write()

        self._write()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="surf-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2 * self.interval)
            self._thread = None
        self._write()

    def beat(self, step: int):
        """Record step progress (called from the main loop)."""
        self._step = step
        self._last_beat = time.monotonic()

    # -- detection -----------------------------------------------------
    def stalled(self) -> bool:
        """True when the step loop has not beaten within stall_timeout
        (the publisher thread may still be alive — a wedged collective
        keeps the process up while the loop stops progressing)."""
        return (time.monotonic() - self._last_beat) > self.stall_timeout

    @staticmethod
    def read(path: str, dead_after: float = 60.0) -> dict:
        """External watchdog view: parsed payload + `dead` flag (file
        missing or wall-clock-stale by `dead_after` seconds)."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"dead": True, "reason": "missing-or-torn"}
        payload["dead"] = (time.time() - payload["time"]) > dead_after
        return payload


class CheckpointDir:
    """Step-numbered atomic npz checkpoints with newest-complete
    discovery.  Filenames: `<prefix>_<step>.npz`."""

    def __init__(self, directory: str, prefix: str = "elastic",
                 keep: int = 3):
        self.dir = directory
        self.prefix = prefix
        self.keep = keep
        # anchored to the FULL filename: a sibling prefix that extends
        # this one ("run" vs "run_fine") must not leak its step numbers
        # into discovery (load_latest would then open a missing path)
        self._pat = re.compile(re.escape(prefix) + r"_(\d+)\.npz\Z")
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{step:09d}.npz")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = self._pat.fullmatch(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: dict[str, Any]):
        """Atomic save: a kill mid-write leaves no `.npz`, only a temp
        file that the next discovery ignores."""
        tmp = self._path(step) + f".tmp.{os.getpid()}"
        arrays = {k: np.asarray(v) for k, v in state.items()}
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, self._path(step))
        self._prune()

    def load(self, step: int):
        """State dict at `step`, or None when that checkpoint is absent."""
        if step not in self.steps():
            return None
        data = np.load(self._path(step))
        return {k: data[k] for k in data.files}

    def load_latest(self):
        """(step, state) of the newest complete checkpoint, or
        (-1, None) when none exists."""
        steps = self.steps()
        if not steps:
            return -1, None
        step = steps[-1]
        data = np.load(self._path(step))
        return step, {k: data[k] for k in data.files}

    def _prune(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass


def run_elastic(step_fn: Callable[[int, dict], dict],
                init_state: dict[str, Any],
                n_steps: int,
                ckpt: CheckpointDir,
                ckpt_every: int = 10,
                max_restarts: int = 3,
                heartbeat: Optional[Heartbeat] = None,
                all_processes: bool = False,
                on_restart: Optional[Callable[[int, Exception], None]]
                = None) -> dict[str, Any]:
    """Run `state = step_fn(step, state)` for steps [0, n_steps) with
    periodic checkpointing and restore-on-failure.

    Resume semantics: if `ckpt` already holds checkpoints (from a
    previous process incarnation), the loop starts after the newest
    one — re-running the same `run_elastic` call after an external
    restart continues the job.  In-process, a step that raises is
    retried from the newest checkpoint up to `max_restarts` times
    (steps since that checkpoint are recomputed — step_fn must be
    deterministic given (step, state) for bit-stable recovery).
    """
    i_am_saver = all_processes or _process_index() == 0
    if all_processes and _process_index() != 0:
        # host-local state: each process gets its own checkpoint
        # namespace, otherwise every rank writes the same filename and
        # the last writer wins (resume would feed rank 0's state — e.g.
        # a data-loader cursor — to every rank)
        ckpt = CheckpointDir(ckpt.dir,
                             f"{ckpt.prefix}.p{_process_index()}",
                             keep=ckpt.keep)
    start, loaded = ckpt.load_latest()
    # Multi-process resume must agree on the step: a rank whose local
    # dir is missing/behind (non-shared FS, torn write) would otherwise
    # restart at a different step and desynchronize every collective.
    # Process 0's view wins; a rank without that checkpoint locally
    # restarts from init (correct for replicated state, and for
    # host-local state it restarts its cursor rather than deadlock).
    if jax is not None:
        try:
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils
                import jax.numpy as _jnp
                agreed = int(multihost_utils.broadcast_one_to_all(
                    _jnp.int32(start)))
                if agreed != start:
                    loaded = None if agreed < 0 else ckpt.load(agreed)
                    start = agreed if loaded is not None else -1
        except Exception:  # single-process / uninitialized runtime
            pass
    state = dict(init_state) if loaded is None else loaded
    step = start + 1
    restarts = 0
    if heartbeat is not None:
        heartbeat.start()
    try:
        while step < n_steps:
            try:
                state = step_fn(step, state)
            except Exception as e:  # noqa: BLE001 — deliberate catch-all
                restarts += 1
                if restarts > max_restarts:
                    raise
                if on_restart is not None:
                    on_restart(step, e)
                back, loaded = ckpt.load_latest()
                if loaded is None:
                    state = dict(init_state)
                    step = 0
                else:
                    state = loaded
                    step = back + 1
                continue
            if heartbeat is not None:
                heartbeat.beat(step)
            if i_am_saver and (step + 1) % ckpt_every == 0:
                ckpt.save(step, state)
            step += 1
        if i_am_saver and (start < n_steps - 1):
            ckpt.save(n_steps - 1, state)
    finally:
        if heartbeat is not None:
            heartbeat.stop()
    return state
