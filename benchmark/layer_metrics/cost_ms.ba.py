"""Milliseconds a refine job's host spends computing and reading each
cost (spans ``ba.cost``: one an attempt and the initial one), summed host
intervals: the host's waits on the device."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.cost", "host_ms")
