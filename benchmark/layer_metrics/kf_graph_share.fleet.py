"""Share of the fleet runner's keyframe groups whose keyframe branch ran as
its CUDA graph: span ``fleet.kf_graph``'s count over ``fleet.keyframe``'s
(0 where the runner ran the branch eagerly, as on the CPU or in a program
without the graph; None where no profiled group keyframed)."""

from benchmark.layer_metrics import _spans


def read(trace):
    s = _spans.stats(trace)
    groups = (s or {}).get("fleet.keyframe", {}).get("count")
    if not groups:
        return None
    return s.get("fleet.kf_graph", {}).get("count", 0) / groups
