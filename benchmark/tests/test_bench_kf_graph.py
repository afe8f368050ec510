"""``kf_graph_share.fleet``: the share of the fleet's profiled keyframe
groups whose keyframe branch ran as the runner's second CUDA graph.  A tiny
traced run on the CPU, where the runner runs the branch eagerly, reads 0,
or leaves the metric out where none of its profiled groups keyframed; the
reader divides the ``fleet.kf_graph`` spans by the ``fleet.keyframe`` spans
and finds nothing, and raises nothing, without spans; a tiny traced run on
a card reads 1 where a profiled group keyframed."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

FLEET = "euroc_mav.fleet5_stream"
METRIC = "kf_graph_share.fleet"


@pytest.fixture
def profiling():
    from mqslam_tpu_torch.utils import profiling
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def read(trace):
    return harness.load_module("layer_metrics", METRIC).read(trace)


def traced_share(device):
    """The metric of a tiny traced run, and whether a profiled group
    keyframed."""
    out, checks = harness.run_cell(tiny.spec(FLEET), 2 ** 31 + 41, 2.0, True,
                                   device, time.perf_counter())
    assert all(v <= lim for _, v, lim in checks), checks
    keyframed = out["metrics"]["keyframe_ms.fleet"]["value"] > 0
    return out["metrics"].get(METRIC), keyframed


def test_tiny_cpu_run_reads_no_graph(profiling):
    m, keyframed = traced_share(torch.device("cpu"))
    assert m == (dict(value=0.0, unit="share") if keyframed else None)


def test_reader_per_keyframe_group(profiling, monkeypatch):
    trace = dict(window_s=1.0)
    assert read(trace) is None                  # tracing was off
    profiling.enable()
    for keyframed, graphed in ((True, True), (False, False), (True, False),
                               (True, True), (False, False), (True, True)):
        with profiling.span("fleet.track_phase"):
            pass
        if keyframed:
            with profiling.span("fleet.keyframe"):
                if graphed:
                    with profiling.span("fleet.kf_graph"):
                        pass
    assert read(trace) == pytest.approx(0.75)   # 3 of 4, not of 6 groups
    assert read(dict(window_s=0.0)) is None     # no profiled window
    monkeypatch.delattr(profiling, "span_stats")
    assert read(trace) is None


def test_reader_without_keyframe_groups(profiling):
    profiling.enable()
    with profiling.span("fleet.track_phase"):
        pass
    assert read(dict(window_s=1.0)) is None


@pytest.mark.card
def test_tiny_card_run_reads_the_graph(cuda_device, profiling):
    m, keyframed = traced_share(cuda_device)
    assert m == (dict(value=1.0, unit="share") if keyframed else None)
