"""Timing / profiling harness.

JAX analogue of the reference's cpuTimer/GpuTimer (cuda_utils.h:71-108):
wall-clock timing around `jax.block_until_ready`, device busy time from
a jax.profiler trace, static kernel counts of a compiled program, and
the card's name and power limit.  chip_smoke.py and bench.py share these,
so both time a program the same way.
"""

from __future__ import annotations

import contextlib
import glob
import os
import shutil
import subprocess
import time

import jax


class Timer:
    """Wall-clock timer that synchronizes on device results."""

    def __init__(self):
        self.elapsed_ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return False


def benchmark(fn, *args, iters: int = 100, warmup: int = 3):
    """Run fn(*args) `iters` times, synchronizing once at the end
    (the reference's 100-iteration protocol, main.cpp:239-251).
    Returns mean milliseconds per iteration."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def steady_ms(fn, args, iters, rounds=3):
    """Per-call milliseconds of `rounds` back-to-back loops of `iters`
    calls, each loop ending in block_until_ready (after one warm-up
    call).  Returns the list of per-round means."""
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn(*args)
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / iters * 1e3)
    return out


def union_length(spans):
    """Total length covered by a list of (start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def busy_intervals_ms(xplane_path, n_iters):
    """Device busy time per iteration from a profiler trace: the union of
    the kernel intervals on the GPU planes' stream lines.  Returns
    (ms per iteration or None, the stream lines read)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    spans, lines = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            lines.add(f"{plane.name}|{line.name}")
            spans += [(ev.start_ns, ev.start_ns + ev.duration_ns)
                      for ev in line.events]
    busy = union_length(spans)
    return (busy / 1e6 / n_iters if spans else None), sorted(lines)


def device_busy_ms(trace_dir, fn, args, iters=5):
    """Trace `iters` calls of fn(*args) (after one warm-up) into
    `trace_dir` (emptied first) and reduce the trace with
    `busy_intervals_ms`."""
    jax.block_until_ready(fn(*args))
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            r = fn(*args)
        jax.block_until_ready(r)
    files = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if len(files) != 1:
        raise RuntimeError(f"expected one trace in {trace_dir}, got {files}")
    return busy_intervals_ms(files[0], iters)


def kernel_count(compiled):
    """Static kernel count of a compiled program: fusion instructions
    (in every computation, loop bodies included) and custom calls
    (library GEMMs, Pallas kernels)."""
    lines = compiled.as_text().splitlines()
    return dict(
        fusions=sum(1 for ln in lines if " fusion(" in ln and "kind=k" in ln),
        custom_calls=sum(1 for ln in lines if "custom-call(" in ln))


def memory_summary(compiled):
    """The byte counts of `compiled.memory_analysis()`."""
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys}


def gpu_name_and_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`:
    one line per card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out


@contextlib.contextmanager
def trace(name: str):
    """Named profiler scope (use with `jax.profiler.start_trace`)."""
    with jax.named_scope(name):
        yield
