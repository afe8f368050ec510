"""Spans, stage clocks, timers and a ``torch.profiler`` trace context.

``span(name, device)`` times a region of the program without draining the
device: when tracing is on it reads the host clock at entry and exit and, on
a CUDA device, records a timing event at each on the current stream; the
events are resolved later (``span_stats``), so a span never synchronizes.
Tracing is on while ``enable()`` is in force or while a ``torch.profiler``
is recording; when off, a span costs one flag check and one query of the
profiler's state.  Every device time is put on the host clock through an
anchor (an event recorded right after a synchronize, beside a host clock
reading), taken when tracing turns on, so a span's device end lines up with
what the host was doing; the clocks drift apart, so ``span_stats`` and each
span that ends in a read-back (``drained``) anchor anew.

``Stages`` is the synchronizing mode of the same regions: given a sink, its
``mark(key)`` waits for the device and adds the host time since the previous
mark to ``sink[key]``, and its ``span(name, key)`` is the span whose exit is
that mark.

``Timer`` is an accumulating wall-clock timer whose ``stop(result)`` waits
for the device work that produced ``result`` (CUDA calls return before the
card finishes, so a clock read without a synchronize measures the enqueue);
``trace(log_dir)`` writes a Chrome trace of the CPU and, where there is a
card, CUDA activity, with every span as a ``record_function`` range.
"""

import collections
import contextlib
import os
import time

import torch

__all__ = ["Timer", "trace", "sync", "span", "enable", "disable", "reset",
           "span_stats", "Stages"]

# pending spans are folded once this many wait, and the oldest dropped past
# MAX_PENDING; the launch queue's depth bounds the events not yet reached,
# so the cap is only a guard
FOLD_AT, MAX_PENDING = 256, 4096


class _Spans:
    """The process's span totals, pending events, event pool and anchors."""

    def __init__(self):
        self.on = False          # enable() in force
        self.ranges = False      # inside trace(): spans open record_function
        self.totals = {}         # name -> [count, host s, end s, device s]
        self.pending = collections.deque()
        self.pool = []
        self.anchors = {}        # device index -> (event, host seconds)

    def event(self, dev):
        ev = self.pool.pop() if self.pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def anchor(self, devs):
        """Put each device's clock of ``devs`` on the host's: one
        synchronize each (after which the spans pending there resolve
        against the old anchor), then an event and a host clock reading.
        The two clocks drift apart (3 ppm on an H100 host), so each
        ``enable()``, ``span_stats()`` and drained span anchors anew."""
        for dev in devs:
            torch.cuda.synchronize(dev)
        self.fold()
        for dev in devs:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            self.anchors[dev.index] = (ev, time.perf_counter())

    def add(self, name, host_s, end_s, device_s):
        t = self.totals.get(name)
        if t is None:
            t = self.totals[name] = [0, 0.0, 0.0, None]
        t[0] += 1
        t[1] += host_s
        t[2] += end_s
        if device_s is not None:
            t[3] = (t[3] or 0.0) + device_s

    def push(self, item):
        self.pending.append(item)
        if len(self.pending) >= FOLD_AT:
            self.fold()
            while len(self.pending) > MAX_PENDING:
                self.pending.popleft()

    def fold(self):
        """Resolve pending spans in order, up to the first whose exit event
        the device has not reached."""
        while self.pending:
            name, t0, t1, e0, e1, i = self.pending[0]
            if not e1.query():
                break
            self.pending.popleft()
            ev, host = self.anchors[i]
            end = host + ev.elapsed_time(e1) / 1e3
            self.add(name, t1 - t0, end - t0, e0.elapsed_time(e1) / 1e3)
            self.pool.append(e0)
            if e1 is not ev:     # a drained span's exit event anchors
                self.pool.append(e1)


_S = _Spans()
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "dev", "drained", "rf", "e0", "t0")

    def __init__(self, name, dev, drained):
        self.name, self.dev, self.drained = name, dev, drained

    def __enter__(self):
        self.rf = None
        if _S.ranges:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        dev = self.dev
        if dev is not None:
            if dev.index not in _S.anchors:
                _S.anchor([dev])  # tracing turned on by a profiler
            self.e0 = _S.event(dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.dev is None:
            _S.add(self.name, t1 - self.t0, t1 - self.t0, None)
        else:
            e1 = _S.event(self.dev)
            if self.drained:
                # the stream is idle: the device reaches e1 as the host
                # records it, so e1 anchors the clocks with no synchronize
                t = time.perf_counter()
                _S.fold()
                _S.anchors[self.dev.index] = (e1, t)
            _S.push((self.name, self.t0, t1, self.e0, e1, self.dev.index))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _cuda(device):
    """``device`` as an indexed CUDA device, or None off CUDA."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device if device.index is not None else \
        torch.device("cuda", torch.cuda.current_device())


def span(name, device=None, drained=False):
    """Context manager timing its block as span ``name`` (None: no span)
    of work on ``device``, while tracing is on; a shared null context
    otherwise.  Never synchronizes.  ``drained``: the block ends waiting
    for the device (a read-back), so its exit anchors the device's clock
    anew at no cost."""
    if name is None or not (_S.on or _profiling()):
        return _NULL
    return _Span(name, _cuda(device), drained)


def enable(device=None):
    """Turn tracing on until ``disable()``; anchors ``device``'s clock (the
    current CUDA device where CUDA is initialized) with one synchronize."""
    _S.on = True
    dev = _cuda(device if device is not None else
                "cuda" if torch.cuda.is_initialized() else None)
    if dev is not None:
        _S.anchor([dev])


def disable():
    """Turn off what ``enable()`` turned on (a recording profiler still
    turns spans on)."""
    _S.on = False


def reset():
    """Forget every span recorded so far."""
    _S.totals.clear()
    _S.pending.clear()


def span_stats(prefix=""):
    """{name: {count, host_ms, end_ms, device_ms}} of the spans whose name
    starts with ``prefix``: the count, the host intervals' sum, the sum of
    each span's time from its host start to its device end (its host end
    off CUDA) and the device intervals' sum (None off CUDA).  Resolves what
    is pending, with one synchronize of each device it is pending on, and
    anchors those devices anew."""
    _S.anchor([torch.device("cuda", i)
               for i in sorted({p[5] for p in _S.pending})])
    ms = lambda s: None if s is None else s * 1e3
    return {k: dict(count=c, host_ms=ms(h), end_ms=ms(e), device_ms=ms(d))
            for k, (c, h, e, d) in sorted(_S.totals.items())
            if k.startswith(prefix)}


class _StageSpan:
    __slots__ = ("clock", "key", "inner")

    def __init__(self, clock, name, key):
        self.clock, self.key = clock, key
        self.inner = span(name, clock.device)

    def __enter__(self):
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        self.clock.mark(self.key)
        return False


class Stages:
    """Host-clock time per stage, each closed by a device synchronize; a
    runner marks its stage boundaries through it, and only a caller that
    passes a ``sink`` (a dict) pays the synchronizes."""

    def __init__(self, sink, device):
        self.sink, self.device = sink, torch.device(device)
        self.t = None

    def mark(self, key=None):
        """Close stage ``key`` (None: only start the next one)."""
        if self.sink is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if key is not None:
            self.sink[key] = self.sink.get(key, 0.0) + (now - self.t) * 1e3
        self.t = now

    def span(self, name, key):
        """``span(name)`` over the block; with a sink, its exit closes stage
        ``key``."""
        if self.sink is None:
            return span(name, self.device)
        return _StageSpan(self, name, key)


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


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block; on exit writes the Chrome trace
    ``log_dir/trace_<pid>.json`` (view in chrome://tracing or Perfetto).
    Records the CPU activity, and the CUDA activity where a card is
    present; each span in the block is also a ``record_function`` range
    (only here: under another profiler a span opens none).  Yields the
    profiler (``key_averages()`` etc.)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        ranges, _S.ranges = _S.ranges, True
        try:
            yield prof
        finally:
            _S.ranges = ranges
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
