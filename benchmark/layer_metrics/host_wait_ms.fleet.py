"""Milliseconds a frame-group the host waits on the device in the fleet
runner's one read-back, ``any(is_kf)`` (span ``fleet.kf_gate``'s host
interval)."""

from benchmark.layer_metrics import _spans


def read(trace):
    return _spans.per_group(trace, "fleet.kf_gate", "host_ms")
