"""Milliseconds a frame-group of the fleet runner's atlas pyramids (span
``fleet.pyramid``: the previous frame's and the new frame's builds summed),
each from its host start to its device end."""

from benchmark.layer_metrics import _spans


def read(trace):
    return _spans.per_group(trace, "fleet.pyramid", "end_ms")
