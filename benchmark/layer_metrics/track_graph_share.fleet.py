"""Share of the fleet runner's frame-groups whose track phase ran as its
CUDA graph: span ``fleet.track_graph``'s count over ``fleet.track_phase``'s
(0 where the runner ran the phase eagerly, as on the CPU or in a program
without the graph)."""

from benchmark.layer_metrics import _spans


def read(trace):
    return _spans.per_group(trace, "fleet.track_graph", "count", absent=0.0)
