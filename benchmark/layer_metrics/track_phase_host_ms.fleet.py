"""Milliseconds a frame-group the host spends in the fleet runner's track
phase (span ``fleet.track_phase``'s host interval), with no synchronize."""

from benchmark.layer_metrics import _spans


def read(trace):
    return _spans.per_group(trace, "fleet.track_phase", "host_ms")
