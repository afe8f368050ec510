"""Milliseconds a refine job spends solving for and applying LM steps
(spans ``ba.step``, one an attempt), summed, each from its host start to
its device end."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.step", "end_ms")
