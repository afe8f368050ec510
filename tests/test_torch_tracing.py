"""``utils.profiling``'s spans and stage clock, and the fleet runner's spans,
on the CPU: a span off records nothing and touches neither CUDA nor the
profiler; on (``enable()`` or a recording profiler) it counts and nests; it
opens ``record_function`` ranges only inside ``profiling.trace``; its
CUDA path (events stood in by fakes) synchronizes once when tracing turns
on and once when resolved, never in a span; a 2-agent fleet streamed group
by group gives bit-equal outputs with tracing off, on and with ``stage_ms``,
one span of each kind a group, ``fleet.keyframe`` on keyframe groups only;
``stage_ms`` keeps its keys in both runners."""

import json
import os
import time

import numpy as np
import pytest
import torch

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.frontend import synthetic, tracker as trk
from mqslam_tpu_torch.frontend.runner import run_frontend
from mqslam_tpu_torch.multiagent.fleet_dump import rodrigues
from mqslam_tpu_torch.ops import features
from mqslam_tpu_torch.utils import profiling

N_FRAMES, SIZE, F, A = 8, (160, 120), 140.0, 2
STAGES = ("fleet.upload", "fleet.pyramid", "fleet.lk", "fleet.track_phase",
          "fleet.kf_gate", "fleet.keyframe")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_spans():
    """Each test starts and ends with tracing off, no spans, no anchors."""
    def clear():
        profiling.disable()
        profiling.reset()
        profiling._S.anchors.clear()
    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def fleet():
    """Two agents over a textured plane, each with its bootstrap, frames
    [A, N, H, W] and injected RANSAC draws."""
    cal = convert.cal_from_numpy([F, F, 0, SIZE[0] / 2, SIZE[1] / 2,
                                  0, 0, 0, 0], device="cpu")
    cfg = trk.TrackerConfig(max_tracks=64, max_landmarks=512,
                            target_keypoints=50, ransac_hypotheses=16)
    tex = synthetic.make_texture(np.random.RandomState(5))
    states, imgs, inits = [], [], []
    for a in range(A):
        P = []
        for i in range(N_FRAMES):
            Pi = np.eye(4)
            Pi[:3, :3] = rodrigues([0, 0.01 * (a - 0.5) * i, 0])
            Pi[:3, 3] = [-0.05 * i * (a + 1), 0.01 * i, 0.3 * a]
            P.append(Pi)
        seq = synthetic.render_plane_sequence(np.stack(P), tex, size=SIZE,
                                              f=F)
        uv, valid = features.detect_corners(torch.as_tensor(seq[0]),
                                            max_corners=64, cell=14)
        uv = uv[valid][:40].numpy()
        objp = synthetic.backproject_to_plane(
            uv, P[0], F, (SIZE[0] / 2, SIZE[1] / 2), 4.0).astype(np.float32)
        states.append(trk.bootstrap(uv, objp, cal, seq[0], cfg,
                                    device="cpu"))
        imgs.append(seq)
        inits.append((uv, objp))
    init = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
    scores = np.random.RandomState(6).rand(
        N_FRAMES - 1, A, cfg.ransac_hypotheses, cfg.max_tracks).astype(
            np.float32)
    run = trk.make_multi_agent_runner(cal, cfg, collect=True, device="cpu")
    return dict(cal=cal, cfg=cfg, init=init, imgs=np.stack(imgs),
                scores=scores, run=run, inits=inits)


def stream(fleet, groups=N_FRAMES - 1, stage_ms=None):
    """The fleet handed one two-frame group a call, as a stream is:
    (final states, [outputs of each group])."""
    st, outs = fleet["init"], []
    for f in range(groups):
        st, o = fleet["run"](st, fleet["imgs"][:, f:f + 2],
                             fleet["scores"][f:f + 1], stage_ms=stage_ms)
        outs.append(o)
    return st, outs


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


class FakeEvent:
    """A CUDA timing event stood in on the CPU: the device reaches it
    ``lag_ms`` after the host records it, on a clock that runs ``rate``
    fast since ``base``, and is done when ``done``; a query takes
    ``query_s``."""
    lag_ms, done, rate, base, query_s = 0.0, True, 0.0, 0.0, 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        h = time.perf_counter() - FakeEvent.base
        self.t = (FakeEvent.base + h * (1 + FakeEvent.rate)) * 1e3 \
            + FakeEvent.lag_ms

    def query(self):
        time.sleep(FakeEvent.query_s)
        return FakeEvent.done

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's events, streams and synchronize stood in; returns the
    list of synchronize calls."""
    synced = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    monkeypatch.setattr(FakeEvent, "lag_ms", 0.0)
    monkeypatch.setattr(FakeEvent, "done", True)
    monkeypatch.setattr(FakeEvent, "rate", 0.0)
    monkeypatch.setattr(FakeEvent, "base", time.perf_counter())
    monkeypatch.setattr(FakeEvent, "query_s", 0.0)
    return synced


def test_a_span_off_records_nothing_and_calls_no_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    s = profiling.span("fleet.track_phase", torch.device("cuda", 0))
    assert s is profiling.span("x", "cpu")          # one shared null context
    with s:
        with profiling.span("y", "cuda:0"):
            pass
    with profiling.Stages(None, "cuda:0").span("z", "stage"):
        pass
    assert profiling.span_stats() == {}


def test_enable_records_nested_spans():
    profiling.enable()
    for _ in range(3):
        with profiling.span("a.outer"):
            for _ in range(2):
                with profiling.span("a.inner"):
                    time.sleep(1e-3)
        with profiling.span(None):                  # a name of None: none
            pass
    with profiling.span("b.other", "cpu"):
        pass
    profiling.disable()
    with profiling.span("a.outer"):
        pass
    s = profiling.span_stats("a.")
    assert set(s) == {"a.outer", "a.inner"}
    assert s["a.outer"]["count"] == 3 and s["a.inner"]["count"] == 6
    assert s["a.outer"]["host_ms"] >= s["a.inner"]["host_ms"] >= 6.0
    # off CUDA the device end is the host end; no device interval
    assert s["a.inner"]["end_ms"] == s["a.inner"]["host_ms"]
    assert s["a.inner"]["device_ms"] is None
    assert profiling.span_stats()["b.other"]["count"] == 1
    profiling.reset()
    assert profiling.span_stats() == {}


def test_spans_are_on_while_a_profiler_records():
    with profiling.span("p.before"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("p.inside"):
            torch.ones(4).sum()
    with profiling.span("p.after"):
        pass
    assert set(profiling.span_stats("p.")) == {"p.inside"}


def test_the_cuda_path_synchronizes_only_to_anchor_and_resolve(fake_cuda,
                                                               monkeypatch):
    """One synchronize when tracing turns on (the anchor), none in any
    span, one when ``span_stats`` resolves (and anchors anew); device ends
    go on the host clock through the anchor; pending events stay
    bounded."""
    dev = torch.device("cuda", 0)
    profiling.enable(dev)
    assert fake_cuda == [dev]
    FakeEvent.lag_ms = 5.0              # the device runs 5 ms behind
    for _ in range(4):
        with profiling.span("c.outer", dev):
            with profiling.span("c.inner", dev):
                time.sleep(1e-3)
    assert fake_cuda == [dev]
    s = profiling.span_stats("c.")
    assert fake_cuda == [dev, dev]          # and anchored anew
    for name in ("c.outer", "c.inner"):
        assert s[name]["count"] == 4
        assert s[name]["end_ms"] - s[name]["host_ms"] == pytest.approx(
            4 * 5.0, abs=0.5)
        assert s[name]["device_ms"] == pytest.approx(s[name]["host_ms"],
                                                     abs=0.5)
    # a device that never reaches the events: folding stops at the first
    # pending one, the oldest are dropped past the cap, still no wait
    monkeypatch.setattr(profiling, "FOLD_AT", 8)
    monkeypatch.setattr(profiling, "MAX_PENDING", 16)
    FakeEvent.done = False
    for _ in range(100):
        with profiling.span("c.stuck", dev):
            pass
        assert len(profiling._S.pending) <= 16
    assert fake_cuda == [dev, dev]
    FakeEvent.done = True
    assert profiling.span_stats("c.stuck")["c.stuck"]["count"] == 16


def test_a_drained_span_anchors_anew_without_a_synchronize(fake_cuda):
    """The device's clock drifts (here 1 %); a span that ends with a
    read-back re-anchors it, so the spans after it map onto the host
    clock again, however long resolving the spans before it takes."""
    dev = torch.device("cuda", 0)
    profiling.enable(dev)
    FakeEvent.rate = 0.01
    FakeEvent.query_s = 0.002
    time.sleep(0.3)
    with profiling.span("d.late", dev):
        pass
    with profiling.span("d.gate", dev, drained=True):
        pass
    with profiling.span("d.after", dev):
        pass
    assert fake_cuda == [dev]
    s = profiling.span_stats("d.")
    assert s["d.late"]["end_ms"] - s["d.late"]["host_ms"] > 2.0
    for name in ("d.gate", "d.after"):
        assert abs(s[name]["end_ms"] - s[name]["host_ms"]) < 0.2


def test_a_profiler_turns_tracing_on_with_one_anchor(fake_cuda):
    dev = torch.device("cuda", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("q.group", dev):
                pass
    assert fake_cuda == [dev]
    assert profiling.span_stats("q.")["q.group"]["count"] == 3


def test_fleet_outputs_bit_equal_with_tracing_and_spans_per_group(
        fleet, monkeypatch):
    synced = []
    st0, outs0 = stream(fleet)
    profiling.enable()
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    st1, outs1 = stream(fleet)
    assert synced == []
    assert same(st0, st1) and all(same(a, b) for a, b in zip(outs0, outs1))
    kf_groups = sum(bool((o[0] == 2).any()) for o in outs0)
    groups = len(outs0)
    assert 0 < kf_groups < groups           # both kinds of group ran
    s = profiling.span_stats("fleet.")
    counts = {k: v["count"] for k, v in s.items()}
    assert counts == {"fleet.group": groups, "fleet.upload": groups,
                      "fleet.pyramid": 2 * groups, "fleet.lk": groups,
                      "fleet.track_phase": groups, "fleet.kf_gate": groups,
                      "fleet.keyframe": kf_groups}
    covered = sum(s[k]["host_ms"] for k in STAGES)
    assert covered <= s["fleet.group"]["host_ms"]
    assert covered >= 0.95 * s["fleet.group"]["host_ms"]


def test_cpu_runner_records_no_track_graph_span(fleet):
    """The track phase's CUDA graph is a card's alone: on the CPU the
    runner runs the phase eagerly and records no ``fleet.track_graph``."""
    profiling.enable()
    stream(fleet, groups=2)
    s = profiling.span_stats("fleet.")
    assert s["fleet.track_phase"]["count"] == 2
    assert "fleet.track_graph" not in s


def test_keyframe_span_only_on_keyframe_groups(fleet):
    profiling.enable()
    st = fleet["init"]
    for f in range(N_FRAMES - 1):
        before = profiling.span_stats("fleet.keyframe").get(
            "fleet.keyframe", {}).get("count", 0)
        st, o = fleet["run"](st, fleet["imgs"][:, f:f + 2],
                             fleet["scores"][f:f + 1])
        after = profiling.span_stats("fleet.keyframe").get(
            "fleet.keyframe", {}).get("count", 0)
        assert after - before == int(bool((o[0] == 2).any()))


def test_fleet_stage_ms_keys_and_outputs(fleet):
    st0, outs0 = stream(fleet, groups=3)
    stage_ms = {}
    st1, outs1 = stream(fleet, groups=3, stage_ms=stage_ms)
    assert set(stage_ms) == {"pyramid", "lk", "track_phase",
                             "keyframe_refill"}
    assert all(v > 0 for v in stage_ms.values())
    assert same(st0, st1) and all(same(a, b) for a, b in zip(outs0, outs1))
    assert profiling.span_stats() == {}     # stage times are no spans


def test_run_frontend_stage_ms_keys(fleet):
    uv, objp = fleet["inits"][1]
    stage_ms = {}
    res = run_frontend(list(fleet["imgs"][1]), fleet["cal"], fleet["cfg"],
                       uv, objp, ransac_scores=fleet["scores"][:, 1],
                       collect_ba=False, device="cpu", stage_ms=stage_ms)
    assert res.n_keyframes >= 2             # frame 0 and a later one
    assert set(stage_ms) == {"pyramid", "lk", "track_keyframe", "host",
                             "refill"}


def test_record_function_ranges_only_inside_trace(fleet, tmp_path):
    """The fleet's spans are ranges of the Chrome trace that
    ``profiling.trace`` writes, and not of another profiler's."""
    def one_group():
        fleet["run"](fleet["init"], fleet["imgs"][:, :2],
                     fleet["scores"][:1])

    with profiling.trace(str(tmp_path / "own")):
        one_group()
    (own,) = os.listdir(tmp_path / "own")
    names = {e.get("name") for e in json.load(
        open(tmp_path / "own" / own))["traceEvents"]}
    assert {"fleet.group", "fleet.track_phase", "fleet.lk"} <= names
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        one_group()
    prof.export_chrome_trace(str(tmp_path / "foreign.json"))
    names = {e.get("name") for e in json.load(
        open(tmp_path / "foreign.json"))["traceEvents"]}
    assert not any(str(n).startswith("fleet.") for n in names)
    # both profilers turned the spans on
    assert profiling.span_stats("fleet.")["fleet.group"]["count"] == 2
