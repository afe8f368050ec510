"""The port's fleet split (``parallel.fleet``), its process start-up
(``parallel.multihost``) and the multi-process dry run
(``parallel.dryrun``) on the CPU.

Tolerances: each rank's share of a split fleet against the unsplit
``make_multi_agent_runner`` with the same injected RANSAC draws —
``accepted`` and every integer / boolean output equal, poses and track
positions within 1e-5 (the same per-agent arithmetic in batches of another
size).  The dry run holds its own checks (the JAX dry run's: joint cost
within 5e-3 of the single-process CG solve, mean ATE front-end -> joint
improves, the corridor at F = 256 and the cube within 5e-3)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import problem as bp, solver as bs
from mqslam_tpu_torch.ba import synthetic as tsyn
from mqslam_tpu_torch.frontend import synthetic, tracker as trk
from mqslam_tpu_torch.multiagent.fleet_dump import rodrigues
from mqslam_tpu_torch.ops import features
from mqslam_tpu_torch.parallel import fleet as pfleet, multihost
from mqslam_tpu_torch.parallel import sharded_ba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, SIZE, F, A = 7, (320, 240), 280.0, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: test files run side by side in parallel
    workers, and one thread each keeps them from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet_inputs():
    cal = convert.cal_from_numpy([F, F, 0, SIZE[0] / 2, SIZE[1] / 2,
                                  0, 0, 0, 0], device="cpu")
    cfg = trk.TrackerConfig(max_tracks=96, max_landmarks=512,
                            target_keypoints=70, ransac_hypotheses=32)
    tex = synthetic.make_texture(np.random.RandomState(5))
    states, imgs = [], []
    for a in range(A):
        P = []
        for i in range(N_FRAMES):
            Pi = np.eye(4)
            Pi[:3, :3] = rodrigues([0, 0.01 * (a - 1.5) * i, 0])
            Pi[:3, 3] = [-0.05 * i, 0.01 * i * (a + 1), 0.3 * a]
            P.append(Pi)
        seq = synthetic.render_plane_sequence(np.stack(P), tex, size=SIZE,
                                              f=F)
        uv, valid = features.detect_corners(torch.as_tensor(seq[0]),
                                            max_corners=64, cell=14)
        uv = uv[valid][:48].numpy()
        objp = synthetic.backproject_to_plane(
            uv, P[0], F, (SIZE[0] / 2, SIZE[1] / 2), 4.0)
        states.append(trk.bootstrap(uv, objp.astype(np.float32), cal,
                                    seq[0], cfg, device="cpu"))
        imgs.append(seq)
    init = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
    scores = torch.as_tensor(np.random.RandomState(6).rand(
        N_FRAMES - 1, A, cfg.ransac_hypotheses, cfg.max_tracks).astype(
            np.float32))
    return cal, cfg, init, torch.as_tensor(np.stack(imgs)), scores


@pytest.mark.parametrize("world", [2, 4])
def test_split_fleet_equals_unsplit(fleet_inputs, world):
    cal, cfg, init, imgs, scores = fleet_inputs
    whole = trk.make_multi_agent_runner(cal, cfg, collect=True, device="cpu")
    ref_final, ref = whole(init, imgs, ransac_scores=scores)
    assert (ref[0] > 0).all()
    per = A // world
    for rank in range(world):
        run = pfleet.make_fleet_runner(cal, cfg, collect=True, device="cpu",
                                       shard=(rank, world))
        final, outs = run(init, imgs, ransac_scores=scores)
        sl = slice(rank * per, (rank + 1) * per)
        assert len(outs) == len(ref) == 9
        for got, want in zip(outs, ref):
            want = want[:, sl]
            assert got.shape == want.shape
            if got.is_floating_point():
                torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
            else:
                assert torch.equal(got, want)
        for got, want in zip(final, ref_final):
            if got.is_floating_point():
                torch.testing.assert_close(got, want[sl], rtol=0, atol=1e-5)
            else:
                assert torch.equal(got, want[sl])


def test_fleet_runner_shapes_and_refusals(fleet_inputs):
    """One rank is ``make_multi_agent_runner`` itself; ``shard_agents``
    takes a rank's agents; agents that do not split, or a group and a shard
    both, are refused."""
    cal, cfg, init, imgs, _ = fleet_inputs
    assert pfleet.make_fleet_runner(cal, cfg, device="cpu").__qualname__ \
        == trk.make_multi_agent_runner(cal, cfg, device="cpu").__qualname__
    st, im = pfleet.shard_agents(init, imgs, 1, 2)
    assert im.shape[0] == 2 and torch.equal(im, imgs[2:])
    assert torch.equal(st.cur_uv, init.cur_uv[2:])
    with pytest.raises(ValueError, match="split"):
        pfleet.shard_agents(init, imgs, 0, 3)
    with pytest.raises(ValueError, match="not both"):
        pfleet.make_fleet_runner(cal, cfg, group=object(), shard=(0, 2),
                                 device="cpu")


def test_multihost_single_process():
    """``initialize`` is a no-op without a coordinator; ``global_group``
    starts a one-rank gloo group, ``solve`` runs the sharded solve over it
    (the collectives still run) and matches ``sharded_lm_solve`` with no
    group; the group is gone afterwards; NCCL is refused where this torch
    has none."""
    assert multihost.initialize() is False
    assert multihost.backend_for("cuda:0") == "nccl"
    assert multihost.backend_for(torch.device("cpu")) == "gloo"
    prob = bp.problem_from_ba_data(tsyn.generate_cube_scenario(
        nr_cameras=2, nr_frames=8, seed=0), device="cpu")
    v0, h0 = sharded_ba.sharded_lm_solve(prob, None, max_iters=10,
                                         cg_iters=150)
    with multihost.global_group("gloo") as g:
        assert dist.get_world_size(g) == 1
        v1, h1 = multihost.solve(prob, g, max_iters=10, cg_iters=150)
    assert not dist.is_initialized()
    v2, h2 = multihost.solve(prob, max_iters=10, cg_iters=150)
    assert not dist.is_initialized()
    assert h1 == h0 and h2 == h0
    assert torch.equal(v1.pose_t, v0.pose_t)
    _, h_cg = bs.lm_solve(prob, max_iters=10, cg_iters=150, method="cg")
    assert abs(h0[-1] / h_cg[-1] - 1) < 5e-3
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError, match="nccl"):
            multihost.initialize("127.0.0.1:1", 2, 0, backend="nccl")


def test_dryrun_two_gloo_processes():
    """``python -m mqslam_tpu_torch.parallel.dryrun --procs 2 --backend
    gloo`` (A = 2, 9 frames, 320x240; corridor F = 256) exits 0 with its
    checks and reports its figures."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "mqslam_tpu_torch.parallel.dryrun",
         "--procs", "2", "--backend", "gloo"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    fl = rep["fleet"]
    assert fl["ranks"] == 2 and fl["agents"] == 2
    assert fl["ate_joint_m"] < fl["ate_front_end_m"]
    assert fl["single_process_rel"] < 5e-3
    assert rep["corridor"]["F"] == 256
    assert rep["corridor"]["single_process_rel"] < 5e-3
    assert rep["cube"]["single_process_rel"] < 5e-3
