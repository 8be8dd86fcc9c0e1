"""Timing helpers for the port's kernels on the card, host and device apart:

* :func:`eager_ms`: CUDA events around back-to-back calls from Python — what
  a caller sees, the wrapper's host time included when it is the longer;
* :func:`graph_ms`: CUDA events around replays of a CUDA graph of the calls
  — the device time per call, without the host;
* :func:`device_kernels`: the names of the device kernels one call runs."""

from __future__ import annotations

import torch


def eager_ms(fn, reps: int = 200) -> float:
    """Mean ms per call of ``reps`` back-to-back calls, after 3 warm-ups."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, calls: int = 50, replays: int = 4) -> float:
    """Device time per call: a CUDA graph of ``calls`` calls, replayed."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def device_kernels(fn) -> list[str]:
    """Names of the device kernels that one call of ``fn`` runs, from a
    profiler window (a window may miss a record now and then); warm ``fn``
    up first."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
