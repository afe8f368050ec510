"""Accumulating wall-clock timers + a ``torch.profiler`` trace context.

A named-timer registry whose ``stop(result)`` waits for the device work that
produced ``result`` (CUDA calls return before the card finishes, so a clock
read without a synchronize measures the enqueue), plus a context that writes
a Chrome trace of the CPU and, where there is a card, CUDA activity.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["Timer", "timers", "trace", "sync"]


def _cuda_devices(obj, out):
    if torch.is_tensor(obj):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    return out


def sync(result):
    """Wait for every CUDA device that holds a tensor of ``result`` (any
    nesting of tuples, lists and dicts); CPU tensors need no wait."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


class Timer:
    """Accumulating timer; use as a context manager or start/stop."""

    def __init__(self, name=""):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result=None):
        if result is not None:
            sync(result)
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return result

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def mean(self):
        return self.total / max(self.count, 1)

    def __repr__(self):
        return (f"Timer({self.name!r}: total={self.total:.4f}s "
                f"n={self.count} mean={self.mean * 1e3:.2f}ms)")


class _Registry(defaultdict):
    def __init__(self):
        super().__init__(Timer)

    def __missing__(self, key):
        t = Timer(key)
        self[key] = t
        return t

    def report(self, printer=print):
        for name in sorted(self):
            printer(repr(self[name]))


timers = _Registry()


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block; on exit writes the Chrome trace
    ``log_dir/trace_<pid>.json`` (view in chrome://tracing or Perfetto).
    Records the CPU activity, and the CUDA activity where a card is
    present.  Yields the profiler (``key_averages()`` etc.)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
