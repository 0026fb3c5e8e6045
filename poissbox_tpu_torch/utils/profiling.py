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

`span` marks a stretch of the solve (PETSc's event names where one exists:
`KSPSolve`, `KSPIteration`, `KSPSync`, `MatMult`, `PCApply`,
`MGLevel<k>`, `FFTSymbol`). A span records only while a `recording()`
window is open or a torch profiler is active; otherwise `span` returns a
shared no-op context after one test. A recorded span keeps its name, its
id, its parent's, its `KSPSolve` root's, the host's `perf_counter_ns` at
entry and exit, and, where the work is on a CUDA card, a pair of timing
events on the current stream (its interval on the device's clock). Under
a profiler it also opens a host range of its name on the profiler's
clock, which the profiler does not copy onto the device's timeline.
Nothing synchronises while a solve runs: `spans()` synchronises once and
computes the durations; the records stay until `reset()`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


_windows = 0              # open recording() windows
_open: list = []          # open spans, innermost last
_done: list = []          # finished spans, in the order they closed
_exported = 0             # how many of _done have their record
_ids = itertools.count()
_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "id", "up", "solve", "stream", "t0", "t1", "ev0", "ev1",
                 "mark", "kids_ns", "kids_ms", "record")

    def __init__(self, name: str, on: Optional[torch.Tensor]):
        self.name = name
        self.up = _open[-1] if _open else None
        # the stream of its events, None off the card: a root's is looked
        # up once (the lookup costs more than recording an event), the
        # rest take their parent's
        self.stream = (self.up.stream if self.up is not None else
                       torch.cuda.current_stream(on.device)
                       if on is not None and on.is_cuda else None)
        self.kids_ns, self.kids_ms = 0, 0.0
        self.ev0 = self.ev1 = self.mark = self.record = None

    def __enter__(self):
        self.id = next(_ids)
        root = _open[0] if _open else self
        self.solve = root.id if root.name == "KSPSolve" else None
        if _autograd_profiler._is_profiler_enabled:
            self.mark = torch._C._profiler._RecordFunctionFast(self.name)
            self.mark.__enter__()
        if self.stream is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _open.pop()
        if self.stream is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self.stream)
        if self.mark is not None:
            self.mark.__exit__(*exc)
            self.mark = None
        if self.up is not None:
            self.up.kids_ns += self.t1 - self.t0
        _done.append(self)
        return False


def span(name: str, on: Optional[torch.Tensor] = None):
    """A context that records the enclosed work as the span `name` while
    a `recording()` window is open or a torch profiler is active, and does
    nothing otherwise; enter it where it is made. A span outside any other
    times the device only where `on`, a tensor of the work, is on a CUDA
    card; one inside another times it where its parent does, on its
    parent's stream."""
    if not (_windows or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, on)


@contextlib.contextmanager
def recording():
    """Record spans in the enclosed work (windows may nest)."""
    global _windows
    _windows += 1
    try:
        yield
    finally:
        _windows -= 1


def reset() -> None:
    """Drop every finished span's record."""
    global _exported
    _done.clear()
    _exported = 0


def spans() -> list:
    """The finished spans' records, in the order they closed: dicts of
    name, id, parent, solve (the id of its `KSPSolve` root, None outside
    one), host_ms and self_host_ms, device_ms and self_device_ms (None
    off the card). A span's self time is its time less its children's.
    Synchronises once where there are device intervals to read."""
    global _exported
    new = _done[_exported:]
    if any(s.ev1 is not None for s in new):
        torch.cuda.synchronize()
    for s in new:
        host_ms = (s.t1 - s.t0) / 1e6
        dev_ms = s.ev0.elapsed_time(s.ev1) if s.ev1 is not None else None
        if dev_ms is not None and s.up is not None:
            s.up.kids_ms += dev_ms
        s.record = {"name": s.name, "id": s.id,
                    "parent": s.up.id if s.up is not None else None,
                    "solve": s.solve, "host_ms": host_ms,
                    "self_host_ms": host_ms - s.kids_ns / 1e6,
                    "device_ms": dev_ms,
                    "self_device_ms": None if dev_ms is None else dev_ms - s.kids_ms}
        s.ev0 = s.ev1 = s.stream = None
    _exported = len(_done)
    return [s.record for s in _done]


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
                reps: int = 3, scale: Optional[float] = None,
                reduce_max: Optional[Callable] = None) -> float:
    """Steady-state seconds per application of `fn` on `example`: `fn`
    chained `lo` and `hi` times (each application reads the last one's
    output), the difference over `hi - lo`. `hi` grows until the
    difference dominates the jitter. `scale` multiplies each output (a
    decay that keeps a chained operator's values finite).

    Where `fn` is a collective (an operator on rank blocks), every rank
    times it together and passes `reduce_max` (the maximum of a 1-D tensor
    over every rank): each timed loop then counts as the slowest rank's,
    so all ranks grow `hi` alike and return the same time."""
    step = fn if scale is None else (lambda v: fn(v) * scale)

    def timed(iters: int) -> float:
        def run():
            v = example
            for _ in range(iters):
                v = step(v)
            return v
        t = _seconds(run, example.device, reps)
        if reduce_max is None:
            return t
        return float(reduce_max(torch.tensor([t], dtype=torch.float64,
                                             device=example.device))[0])

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
