"""Milliseconds a refine job spends in the float64 polish on the host
(span ``ba.polish64``: the reads to the host, the iterations, the result
back on the device), its host interval."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.polish64", "host_ms")
