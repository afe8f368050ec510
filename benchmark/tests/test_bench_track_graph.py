"""``track_graph_share.fleet``: the share of the fleet's profiled
frame-groups whose track phase ran as the runner's CUDA graph.  A tiny
traced run on the CPU, where the runner runs the phase eagerly, reads 0;
the reader divides the ``fleet.track_graph`` spans by the groups and finds
nothing, and raises nothing, without spans; a tiny traced run on a card
reads 1."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

FLEET = "euroc_mav.fleet5_stream"
METRIC = "track_graph_share.fleet"


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
    out, checks = harness.run_cell(tiny.spec(FLEET), 2 ** 31 + 41, 2.0, True,
                                   device, time.perf_counter())
    assert all(v <= lim for _, v, lim in checks), checks
    return out["metrics"][METRIC]


def test_tiny_cpu_run_reads_no_graph(profiling):
    m = traced_share(torch.device("cpu"))
    assert m == dict(value=0.0, unit="share")


def test_reader_per_group(profiling, monkeypatch):
    trace = dict(window_s=1.0)
    assert read(trace) is None                  # tracing was off
    profiling.enable()
    for graphed in (True, True, False, True):
        with profiling.span("fleet.track_phase"):
            if graphed:
                with profiling.span("fleet.track_graph"):
                    pass
    assert read(trace) == pytest.approx(0.75)
    assert read(dict(window_s=0.0)) is None     # no profiled window
    monkeypatch.delattr(profiling, "span_stats")
    assert read(trace) is None


@pytest.mark.card
def test_tiny_card_run_reads_the_graph(cuda_device, profiling):
    assert traced_share(cuda_device) == dict(value=1.0, unit="share")
