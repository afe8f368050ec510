"""Milliseconds a joint refine job spends on the sharded layout (span
``ba.sharded.layout``: the padding, the layout's build and this rank's
shard, on the host), from its host start to its device end, on rank 0."""

from benchmark.layer_metrics import _joint


def read(trace):
    return _joint.per_job(trace, "ba.sharded.layout", "end_ms")
