"""Milliseconds a joint refine job spends in the sharded LM (span
``ba.sharded.lm``: the loop whole), from its host start to its device
end, on rank 0."""

from benchmark.layer_metrics import _joint


def read(trace):
    return _joint.per_job(trace, "ba.sharded.lm", "end_ms")
