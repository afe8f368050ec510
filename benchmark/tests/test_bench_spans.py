"""The fleet runner's span metrics (``upload_ms.fleet``,
``pyramid_ms.fleet``, ``track_phase_host_ms.fleet``, ``host_wait_ms.fleet``,
``keyframe_ms.fleet``): a tiny traced run on the CPU reports each, finite;
the readers find nothing, and raise nothing, where the program records no
spans or has no span mechanism; on a card the fleet's outputs are bit-equal
with tracing off and on, no span synchronizes, and the stage spans cover
the group."""

import math
import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import fleet_stream
from benchmark.tests import tiny

FLEET = "euroc_mav.fleet5_stream"
SPAN_METRICS = ("upload_ms.fleet", "pyramid_ms.fleet",
                "track_phase_host_ms.fleet", "host_wait_ms.fleet",
                "keyframe_ms.fleet")
STAGES = ("fleet.upload", "fleet.pyramid", "fleet.lk", "fleet.track_phase",
          "fleet.kf_gate", "fleet.keyframe")


@pytest.fixture
def profiling():
    from mqslam_tpu_torch.utils import profiling
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def read(name, trace):
    return harness.load_module("layer_metrics", name).read(trace)


def test_traced_run_reports_the_span_metrics(profiling):
    out, _ = harness.run_cell(tiny.spec(FLEET), 2 ** 31 + 29, 2.0, True,
                              torch.device("cpu"), time.perf_counter())
    for name in SPAN_METRICS:
        v = out["metrics"][name]
        assert v["unit"] == "ms" and math.isfinite(v["value"]), name
        assert v["value"] > 0 or name == "keyframe_ms.fleet", name
    assert out["metrics"]["keyframe_ms.fleet"]["value"] >= 0


def test_readers_find_nothing_without_spans(profiling, monkeypatch):
    trace = dict(window_s=1.0, busy_s=0.0)
    # nothing recorded: tracing was off
    with profiling.span("fleet.track_phase"):
        pass
    assert all(read(n, trace) is None for n in SPAN_METRICS)
    # a program without the span mechanism
    monkeypatch.delattr(profiling, "span_stats")
    assert all(read(n, trace) is None for n in SPAN_METRICS)


def test_readers_per_group(profiling):
    profiling.enable()
    for kf in (True, False, False, True):
        with profiling.span("fleet.track_phase"):
            time.sleep(2e-3)
        with profiling.span("fleet.kf_gate"):
            pass
        if kf:
            with profiling.span("fleet.keyframe"):
                time.sleep(2e-3)
    trace = dict(window_s=1.0)
    s = profiling.span_stats("fleet.")
    assert read("track_phase_host_ms.fleet", trace) == pytest.approx(
        s["fleet.track_phase"]["host_ms"] / 4)
    assert read("keyframe_ms.fleet", trace) == pytest.approx(
        s["fleet.keyframe"]["end_ms"] / 4)
    assert read("host_wait_ms.fleet", trace) >= 0
    assert read("upload_ms.fleet", trace) is None     # never recorded


@pytest.mark.card
def test_spans_on_the_card(cuda_device, profiling, monkeypatch):
    """Off, on (``enable()``), off again: outputs bit-equal, no
    synchronize inside the groups once tracing is on, stage spans over
    95 % of the group's host time."""
    cell = tiny.cell(FLEET, device="cuda")
    cell.setup()
    groups = 12

    def stream():
        gen = torch.Generator(device=cell.device).manual_seed(5)
        st, outs = fleet_stream.clone(cell.init), []
        for f in range(groups):
            st, o = cell.run(st, cell.frames[:, f:f + 2], generator=gen)
            outs.append(fleet_stream.clone(o))
        torch.cuda.synchronize()
        return [st] + outs

    def same(a, b):
        return all(torch.equal(x, y) for p, q in zip(a, b)
                   for x, y in zip(p, q))

    off = stream()
    profiling.enable(cell.device)
    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    on = stream()
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    profiling.disable()
    assert synced == [None]                 # stream()'s own, after the groups
    assert same(off, stream()) and same(off, on)
    s = profiling.span_stats("fleet.")
    assert s["fleet.group"]["count"] == groups
    covered = sum(s[k]["host_ms"] for k in STAGES if k in s)
    assert covered >= 0.95 * s["fleet.group"]["host_ms"]
    assert all(v["device_ms"] is not None and v["end_ms"] > 0
               for v in s.values())
