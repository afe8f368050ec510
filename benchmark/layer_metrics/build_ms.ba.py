"""Milliseconds a refine job spends building its problem (span
``ba.build``: the dump's host arrays to tensors on the device), from its
host start to its device end."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.build", "end_ms")
