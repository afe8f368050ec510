"""Milliseconds a joint refine job spends on its reduced costs and their
reads to the host (spans ``ba.sharded.cost``, summed host intervals: the
host's waits on the card and the group), on rank 0."""

from benchmark.layer_metrics import _joint


def read(trace):
    return _joint.per_job(trace, "ba.sharded.cost", "host_ms")
