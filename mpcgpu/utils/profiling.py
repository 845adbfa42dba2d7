"""Profiling/tracing helpers.

The reference instruments with CLOCK_MONOTONIC + cudaDeviceSynchronize fences
(pcg/sqp.cuh:33-35, experiment.cuh:14).  The equivalents here: a blocking
wall timer around jitted calls, and jax.profiler traces for op-level
breakdowns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax


class WallTimer:
    """Blocking wall timer (time_delta_us_timespec equivalent): waits for all
    outputs before reading the clock."""

    def __init__(self):
        self.samples_us = []

    @contextlib.contextmanager
    def measure(self, *outputs):
        t0 = time.perf_counter()
        yield
        for out in outputs:
            jax.block_until_ready(out)
        self.samples_us.append((time.perf_counter() - t0) * 1e6)


def time_jitted(fn, *args, reps: int = 20, warmup: int = 2) -> float:
    """Median wall time (us) of fn(*args) with compile excluded."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        samples.append((time.perf_counter() - t0) * 1e6)
    samples.sort()
    return samples[len(samples) // 2]


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# ---------------------------------------------------------------------------
# profiler-trace reduction: device busy/idle time and per-stage device time
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceEvent:
    name: str            # kernel or host-call name
    start_ns: int
    duration_ns: int
    memcpy: str = ""     # memcpy details ("kind_src:device kind_dst:pinned ...")


def load_trace(path: str) -> tuple[list[TraceEvent], list[TraceEvent]]:
    """(device events, host events) of an ``.xplane.pb`` written by
    jax.profiler; device planes are the GPU ones."""
    data = jax.profiler.ProfileData.from_file(path)
    dev, host = [], []
    for plane in data.planes:
        is_dev = plane.name.startswith("/device:GPU")
        if not is_dev and plane.name != "/host:CPU":
            continue
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                ev = TraceEvent(e.name, int(e.start_ns), int(e.duration_ns),
                                str(stats.get("memcpy_details", "")))
                (dev if is_dev else host).append(ev)
    return dev, host


def busy_ns(events) -> int:
    """Length of the union of the events' intervals."""
    total, end = 0, None
    for s, e in sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                       for ev in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def is_d2h(e: TraceEvent) -> bool:
    return e.name.startswith("MemcpyD2H") or "kind_dst:host" in e.memcpy \
        or "kind_dst:pinned" in e.memcpy


def reduce_trace(dev: list[TraceEvent], host: list[TraceEvent]) -> dict:
    """Device window, busy time and idle share, and the counts that say how
    the loops ran: device kernels (memory copies excluded), device-to-host
    copies, and CUDA-graph launches issued by the host."""
    if not dev:
        raise ValueError("no device events in the trace")
    t0 = min(e.start_ns for e in dev)
    t1 = max(e.start_ns + e.duration_ns for e in dev)
    busy = busy_ns(dev)
    return dict(
        window_ns=t1 - t0, busy_ns=busy, idle_share=1.0 - busy / (t1 - t0),
        kernels=sum(not e.name.startswith("Memcpy") for e in dev),
        d2h_copies=sum(is_d2h(e) for e in dev),
        graph_launches=sum(e.name.startswith("cuGraphLaunch") for e in host),
    )
