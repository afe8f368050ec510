"""Share of a joint refine job's first outer iteration (the traced run's
profiled part) in which no operation ran on rank 0's card, in percent:
``device_idle.frontend``'s arithmetic over the joint cell's trace."""

from benchmark import harness


def read(trace):
    return harness.load_module("layer_metrics",
                               "device_idle.frontend").read(trace)
