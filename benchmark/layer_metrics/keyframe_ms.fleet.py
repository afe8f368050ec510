"""Milliseconds a frame-group of the fleet runner's keyframe phase and
refill (span ``fleet.keyframe``, recorded only on groups where an agent
keyframed), each from its host start to its device end; 0 where none of
the profiled groups keyframed.  Over every profiled group, not only those
that keyframed: a traced run profiles a few groups, and in a share of runs
none of them keyframes, where a mean over keyframe groups has no value."""

from benchmark.layer_metrics import _spans


def read(trace):
    return _spans.per_group(trace, "fleet.keyframe", "end_ms", absent=0.0)
