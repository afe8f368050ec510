"""Milliseconds a refine job spends in the float32 LM (span ``ba.lm``:
``lm_solve`` whole), from its host start to its device end."""

from benchmark.layer_metrics import _ba_spans


def read(trace):
    return _ba_spans.per_job(trace, "ba.lm", "end_ms")
