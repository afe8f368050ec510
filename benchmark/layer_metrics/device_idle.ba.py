"""Share of the profiled refine job(s) in which no operation ran on the
device, in percent: ``device_idle.frontend``'s arithmetic over the BA
cell's traced sub-window."""

from benchmark import harness


def read(trace):
    return harness.load_module("layer_metrics",
                               "device_idle.frontend").read(trace)
