"""Tracing and phase timers (port of
``deepmimic_mujoco_tpu/utils/profiling.py``).

``device_trace`` is the port's counterpart of JAX's ``xla_trace``: a
``torch.profiler`` window around any block, exported as a chrome trace
(``*.trace.json.gz``, viewable in Perfetto or ``chrome://tracing``) under
``logdir``, where ``cli/trace_summary.py`` finds the newest one.
``PhaseTimers`` accumulate wall time per named phase."""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str | None = None, enabled: bool = True):
    """A ``torch.profiler.profile`` of the enclosed block: CPU activity,
    and CUDA activity when a card is present.  The card is synchronized
    before the window closes, so the kernels the block queued are in it.
    Yields the profile (``key_averages()`` reads it after the block); the
    chrome trace is written to ``logdir`` (default ``dmtpu_trace`` under
    the temporary directory) as ``<host>.<pid>.<ns>.trace.json.gz``."""
    if not enabled:
        yield None
        return
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "dmtpu_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
                ".trace.json.gz"))


# the JAX package's name for the same window
xla_trace = device_trace


def device_self_us(prof) -> float:
    """The CUDA self time of a closed profile's ``key_averages()`` in µs:
    the device busy time that ``cli/trace_summary`` reads from the trace
    (0 for work on the CPU alone)."""
    return float(sum(
        getattr(e, "self_device_time_total", 0.0)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA))


class PhaseTimers:
    """Accumulating named phase timers (wall time).  Work queued on a card
    is not waited for: the caller synchronizes inside a phase to time the
    device's work, as JAX's timers see its asynchronous dispatch."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self.totals)
