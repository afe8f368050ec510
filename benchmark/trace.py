"""A short profiled sub-window: device busy time, kernels by name, idle gaps.

The busy and idle arithmetic is a frozen copy of ``prof_torch_multi.py``
(lines 123-140: ``torch.profiler`` over CPU and CUDA activity, device rows
only, busy = device time, idle = 1 - busy / wall), with two changes: busy
time is the union of the device's activity intervals (an overlap is not
counted twice), and the wall time is that of the profiled window itself,
so the idle share is of the window the trace covers.  The idle gaps are
named by the innermost host operation running at each gap's middle.
"""

import bisect
import time

import torch

__all__ = ["profile", "union_seconds", "gaps_by_host_op"]

NAME_CHARS = 120      # kernel names in the breakdown are cut to this


def _device_events(events):
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA]


def _host_events(events):
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CPU
            and not e.name.startswith(("ProfilerStep", "[memory]"))]


def union_seconds(intervals):
    """(merged intervals, total seconds) of (start_us, end_us) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged) / 1e6


def gaps_by_host_op(merged, host, top=10):
    """Idle gaps between merged device intervals, summed by the innermost
    host operation covering each gap's middle: [[name, seconds], ...]."""
    host = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by_name = {}
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        mid = e0 + gap / 2
        i = bisect.bisect_right(starts, mid) - 1
        best, name = None, "(host between operators)"
        for e in host[max(i - 400, 0):i + 1][::-1]:
            if e.time_range.start <= mid <= e.time_range.end:
                d = e.time_range.end - e.time_range.start
                if best is None or d < best:
                    best, name = d, e.name
        by_name[name] = by_name.get(name, 0.0) + gap / 1e6
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:top]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile(steps, top=10):
    """``steps(on, off)`` runs work and calls ``on()`` / ``off()`` around
    the part to trace, under ``torch.profiler``.  Returns the trace:
    busy_s, window_s (between on and off), device time by kernel name
    (``kernels``: {name: (seconds, count)}), the breakdown
    (``device_ops``, ``idle_gaps``) and what ``steps`` returned, under
    ``recorded``."""
    from torch.profiler import ProfilerActivity
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    box = {}

    def on():
        _sync()
        prof.start()
        box["t0"] = time.perf_counter()

    def off():
        _sync()
        box["window_s"] = time.perf_counter() - box["t0"]
        prof.stop()

    recorded = steps(on, off)
    events = prof.events()
    dev = _device_events(events)
    merged, busy_s = union_seconds(
        [(e.time_range.start, e.time_range.end) for e in dev])
    kernels = {}
    for e in dev:
        s, c = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (s + (e.time_range.end - e.time_range.start) / 1e6,
                           c + 1)
    ops = sorted(([k[:NAME_CHARS], v[0]] for k, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy_s, window_s=box["window_s"], kernels=kernels,
                recorded=recorded,
                breakdown=dict(device_ops=ops,
                               idle_gaps=gaps_by_host_op(
                                   merged, _host_events(events), top)))
