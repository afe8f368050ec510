"""Milliseconds a frame-group of the fleet runner's upload (span
``fleet.upload``: the frames' float32 conversion and copy, and the states,
to the device), from its host start to its device end."""

from benchmark.layer_metrics import _spans


def read(trace):
    return _spans.per_group(trace, "fleet.upload", "end_ms")
