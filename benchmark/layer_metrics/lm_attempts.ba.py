"""LM attempts a refine job makes: the count of spans ``ba.step``, one a
solve and update whether the step is taken or not."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.step", "count")
