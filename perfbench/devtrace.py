"""What the benchmark takes from a torch.profiler trace of its traced
window: device time by kernel name, the device's busy seconds, and the
longest idle gaps by what the host was doing.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

# copies and fills the profiler lists beside the kernels; not launches
NOT_KERNELS = ("Memcpy", "Memset")


@contextlib.contextmanager
def traced():
    """torch.profiler over the enclosed work: the host, and the card where
    there is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _device_us(evt) -> float:
    return next((float(getattr(evt, a)) for a in (
        "self_device_time_total", "self_cuda_time_total", "device_time_total",
        "cuda_time_total") if getattr(evt, a, 0)), 0.0)


def kernel_table(prof) -> dict:
    """{name: [calls, device seconds]} of every device operation. A host
    range the profiler also draws on the device's timeline (a
    record_function) is not one: its name is a host event's too."""
    events = prof.key_averages()
    host = {evt.key for evt in events if not _is_device(evt)}
    return {evt.key: [int(evt.count), _device_us(evt) / 1e6] for evt in events
            if _is_device(evt) and evt.key not in host
            and not getattr(evt, "is_user_annotation", False)}


def summarise(table: dict) -> dict:
    """Device seconds in all, and kernel launches."""
    launches = sum(c for name, (c, _) in table.items()
                   if not name.startswith(NOT_KERNELS))
    return {"device_s": sum(s for _, s in table.values()), "launches": launches}


def top_ops(table: dict, k: int = 10) -> list:
    """The k device operations that took most time: [[name, seconds]]."""
    rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:k]
    return [[name, s] for name, (_, s) in rows]


def idle_gaps(prof, k: int = 10) -> list:
    """The device's idle time between its operations, summed by the innermost host operation running at
    each gap's midpoint ("python" where none ran): [[name, seconds]], the
    k largest."""
    try:
        events = list(prof.events())
    except (AssertionError, RuntimeError):
        return []
    dev = sorted((e.time_range.start, e.time_range.end) for e in events if _is_device(e))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _is_device(e)]
    if len(dev) < 2:
        return []
    host.sort()
    gaps = defaultdict(float)
    active, nxt = [], 0            # host events open at the current midpoint
    end = dev[0][1]
    for start, stop in dev[1:]:
        if start > end:
            mid = 0.5 * (start + end)
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            inner = min(active, key=lambda h: h[1] - h[0], default=None)
            gaps[inner[2] if inner else "python"] += (start - end) / 1e6
        end = max(end, stop)
    return [[name, s] for name, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:k]]
