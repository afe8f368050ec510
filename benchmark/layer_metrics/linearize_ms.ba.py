"""Milliseconds a refine job spends linearizing (spans ``ba.linearize``,
one an LM outer iteration), summed, each from its host start to its device
end."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.linearize", "end_ms")
