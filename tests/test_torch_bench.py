"""The port bench (``python -m mqslam_tpu_torch.bench``) on the CPU at tiny
sizes: every section runs and returns numbers of the right shape, the JSON
line carries the JAX bench's metric and the ``extra`` keys of its sections
(BA at scale and loop closure included).  Times taken here are CPU times
and mean nothing about the card."""

import json
import math

import numpy as np
import pytest
import torch

from mqslam_tpu_torch import bench
from mqslam_tpu_torch.frontend import synthetic, tracker as trk

SIZE, F = (320, 240), 250.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny eager runs: beside parallel test workers, torch's threads spin
    against each other (a fleet run took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    seq = synthetic.build_sequence(n_frames=7, size=SIZE, f=F,
                                   vel=(0.3, 0.05, 0.05))
    config = trk.TrackerConfig(max_tracks=128, target_keypoints=100)
    cal, config, state = bench._bootstrap_state(*seq, device="cpu",
                                                config=config)
    return seq, cal, config, state


def positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0


def test_single_and_fleets(setup):
    (imgs, *_), cal, config, state = setup
    fps, ok, n = bench.bench_single(cal, config, state, imgs, repeats=1,
                                    device="cpu")
    assert positive(fps) and n == 6 and ok == n
    fps, ok, n = bench.bench_multi(cal, config, state, imgs, 2, repeats=1,
                                   device="cpu")
    assert positive(fps) and n == 12 and ok == n
    seqs = bench.render_fleet(3, n_frames=4, size=SIZE, f=F, workers=1)
    fps, ok, n = bench.bench_multi_divergent(cal, config, 2, repeats=1,
                                             device="cpu", seqs=seqs)
    assert positive(fps) and n == 6 and ok == n


def test_lk_impls_and_efficiency(setup):
    (imgs, *_), *_ = setup
    lk_ms = bench.bench_lk_impls(imgs, n_scan=2, repeats=1, n_tracks=32,
                                 device="cpu")
    assert list(lk_ms) == ["xla", "pallas", "fused", "tiled"]
    assert all(positive(v) for v in lk_ms.values())
    eff = bench.lk_efficiency(lk_ms, size=SIZE, n_tracks=32)
    assert set(eff) == {"lk_bytes_moved_mb", "lk_hbm_sol_ms",
                        "lk_x_over_hbm_sol"}
    # per level the smaller of 32 tracks' regions (24^2 + 36^2 floats each)
    # and both padded level images (the 96 x 116 top level is smaller), plus
    # 49 bytes per track
    region = 32 * (24 ** 2 + 36 ** 2) * 4
    assert eff["lk_bytes_moved_mb"] == pytest.approx(
        (2 * region + 2 * 96 * 116 * 4 + 3 * 32 * 49) / 1e6)
    assert eff["lk_x_over_hbm_sol"] == pytest.approx(
        lk_ms["tiled"] / (eff["lk_bytes_moved_mb"] * 1e6 / 3.35e12 * 1e3))
    assert bench.lk_efficiency({}) == {}


def test_triangulation(setup):
    out = bench.bench_triangulation(n_scan=2, repeats=1, N=256,
                                    device="cpu")
    for name in ("linear_eigen", "linear_ls", "iterative_ls", "optimal"):
        assert positive(out[name + "_mps"])
    assert out["batch"] == 256
    try:
        import cv2  # noqa: F401
        assert positive(out["cv2_linear_eigen_mps"])
    except ImportError:
        assert "cv2_linear_eigen_mps" not in out


def test_ba_iters():
    """The BA section on the cube (one robot, 6 frames, 3 iterations): the
    JAX bench's keys, the incremental figure null (the JAX bench gives it
    only on its real dump, which is not in the repo)."""
    out = bench.bench_ba_iters(max_iters=3, repeats=1, nr_cameras=1,
                               nr_frames=6, device="cpu")
    assert set(out) == {"ba_lm_iterations_per_s",
                        "ba_lm_iterations_per_s_host_loop",
                        "ba_incremental_steps_per_s", "ba_workload"}
    assert positive(out["ba_lm_iterations_per_s"])
    assert positive(out["ba_lm_iterations_per_s_host_loop"])
    assert out["ba_incremental_steps_per_s"] is None
    assert out["ba_workload"] == "synthetic-cube-1cam"


def test_corridor_cg():
    """The corridor-CG section on a small corridor (F = 64, 8 landmarks a
    frame): the JAX bench's keys for the three layouts, and each layout's
    bytes against the card's memory rate.  The slope is a difference of
    two host times, so the test takes the best of 3 on one torch thread:
    on a CPU shared with other test workers one stalled run of the
    25-iteration budget made it negative."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = bench.bench_corridor_cg(F=64, ppf=8, repeats=3, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert (out["F"], out["P"]) == (64, 512) and out["O"] > 3000
    for k in ("Kf", "Kp", "banded_J", "banded_Ks", "banded_left",
              "banded_L"):
        assert isinstance(out[k], int) and out[k] >= 0, k
    for name in ("banded", "packed", "coo"):
        assert positive(out[name + "_cg_iter_ms"])
        assert out[name + "_cg_iters_per_s"] == pytest.approx(
            1e3 / out[name + "_cg_iter_ms"])
    eff = bench.cg_efficiency(out)
    for prefix in ("cg_", "banded_cg_", "coo_cg_"):
        for k in ("bytes_moved_mb", "hbm_sol_ms", "x_over_hbm_sol"):
            assert positive(eff[prefix + k]), prefix + k
        assert eff[prefix + "hbm_sol_ms"] == pytest.approx(
            eff[prefix + "bytes_moved_mb"] * 1e6 / 3.35e12 * 1e3)
    assert eff["coo_cg_bytes_moved_mb"] == pytest.approx(
        (out["O"] * 80 + 512 * 60 + 64 * 48) / 1e6)
    # a layout whose builder refused the problem has no row
    assert bench.cg_efficiency({"F": 64, "P": 512, "O": 10}).keys() == set()


LOOP = {"orb_db_scores_per_s": 900.0, "db_keyframes": 256,
        "pgo_iters_per_s": 12.0, "pgo_poses": 512, "pgo_edges": 527}


def test_loopclosure_section():
    """The JAX bench's loop-closure workloads, cut to a tiny DB and circuit
    here: its keys, and the circuit's edges (the odometry chain, then a
    closure edge every N // 16 poses to the opposite side)."""
    inputs = bench.loopclosure_inputs(cap=8, K=16, N=32, device="cpu")
    db, q_desc, q_valid, g = inputs
    assert db.desc.shape == (8, 16, 32) and int(db.count) == 8
    assert q_desc.shape == (16, 32) and bool(q_valid.all())
    ei, ej = g.edge_i.numpy(), g.edge_j.numpy()
    assert len(ei) == 31 + 16
    np.testing.assert_array_equal(ei[31:], np.arange(0, 32, 2))
    np.testing.assert_array_equal(ej[31:], (np.arange(0, 32, 2) + 16) % 32)
    out = bench.bench_loopclosure(repeats=1, n_scan=2, cap=8, K=16, N=32,
                                  device="cpu")
    assert out.keys() == LOOP.keys()
    assert positive(out["orb_db_scores_per_s"])
    assert positive(out["pgo_iters_per_s"])
    assert (out["db_keyframes"], out["pgo_poses"], out["pgo_edges"]) == (
        8, 32, 47)


def test_json_line(setup):
    (imgs, P_list, f, size, plane_z), *_ = setup
    base = bench.bench_opencv_baseline(imgs, P_list, f, size, plane_z,
                                       passes=1)
    assert base is None or positive(base)
    line = json.dumps(bench.summary(
        {1: 4.0, 2: 7.5, 4: 6.0}, {8: 9.0}, 4.0,
        {"xla": 1.0, "pallas": 2.0, "fused": 0.5, "tiled": 0.4},
        {"linear_ls_mps": 3.0}, {"lk_x_over_hbm_sol": 5.0}, 30.0,
        {"kind": "a card"},
        {"ba_lm_iterations_per_s": 20.0,
         "ba_lm_iterations_per_s_host_loop": 15.0,
         "ba_incremental_steps_per_s": None,
         "ba_workload": "synthetic-cube-2cam"},
        {"F": 2048, "coo_cg_iter_ms": 9.0}, LOOP))
    out = json.loads(line)
    assert out["metric"] == "slam_frontend_aggregate_frames_per_s_per_chip"
    assert out["unit"] == "frames/s"
    assert out["value"] == 7.5 and out["vs_baseline"] == 0.25
    extra = out["extra"]
    assert extra["best_A"] == 2
    assert extra["agents_scaling_fps"] == {"1": 4.0, "2": 7.5, "4": 6.0}
    assert set(extra["lk_per_call_ms"]) == {"xla", "pallas", "fused",
                                            "tiled"}
    # the BA, corridor and loop-closure sections' keys as the JAX bench
    # names them; the incremental figure is null on the cube
    assert extra["ba_lm_iterations_per_s"] == 20.0
    assert extra["ba_lm_iterations_per_s_host_loop"] == 15.0
    assert extra["ba_incremental_steps_per_s"] is None
    assert extra["ba_workload"] == "synthetic-cube-2cam"
    assert extra["corridor_cg"] == {"F": 2048, "coo_cg_iter_ms": 9.0}
    assert extra["loop_closure"] == LOOP
    assert bench.NOT_PORTED == ()


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
