"""mqslam_tpu_torch.utils.profiling and studies.rolling_shutter on the CPU:
the Timer's semantics, a trace written on the CPU activity, and the
rolling-shutter study against the JAX package's on the same frames
(deviations within 2e-3 px, classes equal)."""

import json
import os

import numpy as np
import pytest
import torch

from mqslam_tpu.studies import rolling_shutter as jrs
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.frontend import synthetic
from mqslam_tpu_torch.studies import rolling_shutter as trs
from mqslam_tpu_torch.utils import Timer, cuda_graph, profiling


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_timer_accumulates():
    t = Timer("x")
    with t:
        sum(range(1000))
    with t:
        sum(range(1000))
    assert t.count == 2
    assert t.total > 0
    assert t.mean == t.total / 2
    assert "x" in repr(t) and "n=2" in repr(t)
    assert Timer().mean == 0.0


def test_timer_stop_returns_result_and_syncs_cuda_only(monkeypatch):
    """``stop(result)`` returns the result; it waits for each CUDA device
    that holds a tensor of it (any nesting), and for nothing else."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    res = {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}
    t = Timer("cpu").start()
    assert t.stop(res) is res
    assert synced == [] and t.count == 1
    meta = [torch.ones(2, device="meta")]
    assert profiling.sync(meta) is meta and synced == []
    # a CUDA tensor: stand in a device-typed object for the search
    cuda = torch.device("cuda", 0)

    class FakeCuda:
        device = cuda
    monkeypatch.setattr(torch, "is_tensor",
                        lambda x: isinstance(x, (torch.Tensor, FakeCuda)))
    t.start()
    t.stop({"x": [(FakeCuda(), torch.ones(1))], "y": FakeCuda()})
    assert synced == [cuda] and t.count == 2


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_graphed_off_a_card_is_the_function_itself(monkeypatch):
    """Off a card ``Graphed`` hands ``fn`` the caller's own tensors and
    returns ``fn``'s own outputs: no copy in or out, no capture and no
    span, even while tracing is on."""
    def no_cuda(*a, **k):
        raise AssertionError("Graphed reached for CUDA off a card")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_cuda)
    monkeypatch.setattr(torch.cuda, "Stream", no_cuda)
    calls = []

    def fn(x, y):
        calls.append(((x, y), (x + y, y * 2)))
        return calls[-1][1]
    g = cuda_graph.Graphed(fn, "cpu", "test.graph")
    x, y = torch.ones(3), torch.arange(3.0)
    profiling.reset()
    profiling.enable()
    try:
        outs = [g(x, y) for _ in range(2)]
        stats = profiling.span_stats()
    finally:
        profiling.disable()
        profiling.reset()
    assert len(calls) == 2
    for (args, ret), out in zip(calls, outs):
        assert args[0] is x and args[1] is y
        assert out is ret
    assert g.graphs == {} and stats == {}


def test_classify_tracks(rng):
    dev_x = np.array([[0.0, 0.3, 0.8, 2.0, 5.0],
                      [0.0, -0.3, -0.8, -2.0, -5.0]])
    dev_y = np.array([[0.0, 0.1, 0.1, 0.1, 4.0],
                      [0.0, -0.1, -0.1, -0.1, -4.0]])
    classes, stds = trs.classify_tracks(dev_x, dev_y)
    for k, v in {"zero": [0], "half": [1], "one": [2], "three": [3],
                 "bad": [4]}.items():
        assert list(classes[k]) == v
    dev_x = rng.randn(9, 40) * 2
    dev_y = rng.randn(9, 40) * 2
    dev_x[:, :3] = 0
    got = trs.classify_tracks(dev_x, dev_y)
    want = jrs.classify_tracks(dev_x, dev_y)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    assert got[1] == want[1]


def jitter_poses(n, seed, max_rot):
    """A camera at rest that turns by small random rotations (frame 0 at
    rest)."""
    r = np.random.RandomState(seed).uniform(-max_rot, max_rot, (n, 3))
    r[0] = 0
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = so3.exp(torch.tensor(r)).numpy()
    return P


@pytest.mark.parametrize("scene", ["static", "jitter"])
def test_analyze_sequence(rng, scene):
    """The JAX test's 160x120 sequence: four frames of a static camera,
    and six of one that jitters by up to ~1 px."""
    tex = synthetic.make_texture(rng)
    P = (np.eye(4)[None].repeat(4, axis=0) if scene == "static"
         else jitter_poses(6, 5, 6e-3))
    imgs = list(synthetic.render_plane_sequence(P, tex, size=(160, 120),
                                                f=140.0))
    got = trs.analyze_sequence(imgs, max_tracks=64, device="cpu")
    want = jrs.analyze_sequence(imgs, max_tracks=64)
    assert got.deviations_x.shape == want.deviations_x.shape
    assert got.deviations_x.shape[1] >= 40
    np.testing.assert_allclose(got.deviations_x, want.deviations_x,
                               atol=2e-3)
    np.testing.assert_allclose(got.deviations_y, want.deviations_y,
                               atol=2e-3)
    for k in want.classes:
        np.testing.assert_array_equal(got.classes[k], want.classes[k])
    if scene == "static":
        assert np.abs(got.deviations_x).max() < 0.3
    else:
        assert sum(len(v) > 0 for v in got.classes.values()) >= 2
