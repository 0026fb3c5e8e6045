"""Profiling — the `-log_view` analogue (port of
:mod:`poissbox_tpu.utils.profiling`).

`trace` wraps `torch.profiler` (the card's kernels come from its CUPTI
trace); `kernel_time` measures the steady-state time of one application
of a field -> field function by the differenced protocol: chain the
applications in a loop of two lengths and take the difference, so the
constant cost of starting and ending a timed loop cancels. On a CUDA
tensor each timed loop runs between two `torch.cuda.Event`s and ends in a
synchronise (device time, the host's enqueue included where it is the
slower); on the CPU it is host time. `solve_time` is the same protocol over
whole solves, and `bandwidth_gbps` turns a time into a rate.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the enclosed work with `torch.profiler` (the CPU, and the
    card when there is one) and yield the profiler; with `logdir`, write a
    Chrome/Perfetto trace `trace.json` there on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_times(prof) -> dict:
    """{kernel name: (calls, device microseconds)} of a finished `trace`;
    empty when the profiler saw no device (the CPU, or a card it could not
    trace)."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = next((float(getattr(evt, a)) for a in (
            "self_device_time_total", "self_cuda_time_total", "device_time_total",
            "cuda_time_total") if getattr(evt, a, 0)), 0.0)
        out[evt.key] = (int(evt.count), us)
    return out


def _seconds(run: Callable[[], object], device: torch.device, reps: int) -> float:
    """The shortest of `reps` timed calls of `run` (after one warm call)."""
    run()
    cuda = device.type == "cuda"
    best = float("inf")
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def _differenced(timed: Callable[[int], float], lo: int, hi: int, cap: int) -> float:
    """(t(hi) - t(lo)) / (hi - lo), `hi` grown (x4, up to `cap`) until the
    difference clearly exceeds the jitter of a timed loop."""
    t_lo = timed(lo)
    t_hi = timed(hi)
    while hi < cap and (t_hi - t_lo) <= max(0.5 * t_lo, 0.020):
        hi *= 4
        t_hi = timed(hi)
    return max((t_hi - t_lo) / (hi - lo), 1e-12)


def kernel_time(fn: Callable, example: torch.Tensor, lo: int = 10, hi: int = 40,
                reps: int = 3, scale: Optional[float] = None) -> float:
    """Steady-state seconds per application of `fn` on `example`: `fn`
    chained `lo` and `hi` times (each application reads the last one's
    output), the difference over `hi - lo`. `hi` grows until the
    difference dominates the jitter. `scale` multiplies each output (a
    decay that keeps a chained operator's values finite)."""
    step = fn if scale is None else (lambda v: fn(v) * scale)

    def timed(iters: int) -> float:
        def run():
            v = example
            for _ in range(iters):
                v = step(v)
            return v
        return _seconds(run, example.device, reps)

    return _differenced(timed, lo, hi, 20000)


def solve_time(solve_fn: Callable, b: torch.Tensor, lo: int = 1, hi: int = 3,
               reps: int = 3) -> float:
    """Seconds per full solve by the differenced protocol: `solve_fn(b)`
    repeated `lo` and `hi` times back to back, each loop ending in a
    synchronise on the card."""
    def timed(iters: int) -> float:
        def run():
            for _ in range(iters):
                solve_fn(b)
        return _seconds(run, b.device, reps)

    return _differenced(timed, lo, hi, 256)


def bandwidth_gbps(fn: Callable, example: torch.Tensor, passes: int = 2, **kw) -> float:
    """Effective memory bandwidth assuming `passes` full-array passes per
    application (2 = read + write for a perfectly fused kernel)."""
    t = kernel_time(fn, example, **kw)
    return passes * example.numel() * example.element_size() / t / 1e9
