"""Milliseconds a joint refine job spends in its LM attempts' solves and
updates (spans ``ba.sharded.step``: the Schur-CG ``solve_delta`` with its
all-reduces, and ``apply_delta``), summed from host start to device end,
on rank 0."""

from benchmark.layer_metrics import _joint


def read(trace):
    return _joint.per_job(trace, "ba.sharded.step", "end_ms")
