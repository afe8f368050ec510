"""CG iterations a joint refine job runs (counter ``ba.cg_iters``: the
iterations each ``solve_delta`` returns, summed on the device), on rank
0; every rank runs the same."""

from benchmark.layer_metrics import _joint


def read(trace):
    return _joint.counter_per_job(trace, "ba.cg_iters")
