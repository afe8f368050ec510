"""The sharded LM's stop rule, spans and counters, and a small merged fleet
solved over two gloo ranks against the float64 reference.

- ``sharded_lm_solve(rtol=...)`` stops where ``lm_solve(rtol=...)`` does:
  over COO rows with no group the two run the same operations, so their
  histories are equal; with the defaults (``rtol`` 0, ``cg_tol`` 1e-10)
  it is bit-equal to the loop it replaced (``_parent_loop``: the sharded
  iteration, a linearization every attempt, the same accept rule).
- Two gloo ranks in child processes (no JAX) solve a merged fleet of three
  agents over 16 frames (the benchmark's ``joint_refine`` traffic at 160 x
  120, rendezvous every 4 frames) with the configuration's solver
  settings, tracing on: the spans ``ba.sharded.*`` have the counts the
  loop implies, the counter ``ba.cg_iters`` is the sum of the iterations
  ``solve_delta`` returns, ``ba.allreduce_bytes`` counts every
  ``all_reduce`` and its bytes, both ranks hold the same answer, and rank
  0's answer lies at the float64 optimum of ``benchmark/reference/
  ba_joint.py`` within: cost 1e-5 relative (float32 costs resolve ~1e-7
  of it, and ``rtol`` 1e-5 stops once an iteration gains less than 1e-5),
  centres 1e-4 m and rotations 1e-4 rad (the map's float32 roundoff moves
  them ~1e-6), determined landmarks 1e-3 of their depth; the CPU run
  reads 2.5e-7, 1.5e-6 m, 3.9e-7 rad and 1.1e-6.
- Tracing off, the solver records nothing: no span, no counter.

torch runs on one thread here so that its sums have one order."""

import copy
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from mqslam_tpu_torch.ba import problem as bp, solver as ts
from mqslam_tpu_torch.ba import synthetic as tsyn
from mqslam_tpu_torch.parallel import multihost, sharded_ba as tsb
from mqslam_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracing():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def problems():
    cube = bp.problem_from_ba_data(tsyn.generate_cube_scenario(
        nr_cameras=2, nr_frames=12, seed=0), device="cpu")
    corr, _ = tsyn.generate_corridor_problem(nr_frames=24,
                                             points_per_frame=6,
                                             device="cpu")
    return dict(cube=cube, corridor=corr)


def _parent_loop(problem, max_iters, cg_iters, layout):
    """The loop ``sharded_lm_solve`` ran before it took ``rtol``: the
    sharded iteration (a linearization every attempt) and the same
    accept rule, with no group."""
    padded = tsb.pad_problem_for_shards(problem, 1)
    if isinstance(layout, str):
        out = tsb.build_banded_for_mesh(padded, None)
        if out is not None:
            layout, padded = out
        else:
            layout = tsb.build_layout_for_mesh(padded, None)
    problem = tsb.shard_problem_for_mesh(padded, None)
    lm_iter = tsb.make_sharded_lm_iteration(None, cg_iters=cg_iters)
    v, lam = problem.init, 1e-6
    cost = float(ts.compute_cost(problem, v))
    history = [cost]
    for _ in range(max_iters):
        improved = False
        for _ in range(6):
            dc, dp, _ = lm_iter(problem, v, lam, layout)
            v_try = ts.apply_delta(v, dc, dp)
            nc = float(ts.compute_cost(problem, v_try))
            if nc < cost:
                v, cost = v_try, nc
                lam = max(lam / 2.0, 1e-9)
                improved = True
                break
            lam = min(lam * 8.0, 1e6)
        history.append(cost)
        if not improved:
            break
    return v, history


@pytest.mark.parametrize("name", ["cube", "corridor"])
@pytest.mark.parametrize("layout", ["auto", None])
def test_defaults_bit_equal_to_the_parent_loop(problems, name, layout):
    p = problems[name]
    v, hist = tsb.sharded_lm_solve(p, None, max_iters=8, cg_iters=150,
                                   layout=layout)
    v0, hist0 = _parent_loop(p, 8, 150, layout)
    assert hist == hist0
    assert all(torch.equal(a, b) for a, b in zip(v, v0))


@pytest.mark.parametrize("rtol", [1e-4, 1e-3])
@pytest.mark.parametrize("name", ["cube", "corridor"])
def test_rtol_stops_where_lm_solve_does(problems, name, rtol):
    p = problems[name]
    v, hist = tsb.sharded_lm_solve(p, None, max_iters=20, cg_iters=100,
                                   layout=None, rtol=rtol, cg_tol=1e-8)
    v1, hist1 = ts.lm_solve(p, max_iters=20, cg_iters=100, cg_tol=1e-8,
                            method="cg", layout=None, rtol=rtol)
    assert hist == hist1 and len(hist) < 21
    assert all(torch.equal(a, b) for a, b in zip(v, v1))
    _, dev_hist, n = tsb.sharded_lm_solve_device(
        p, None, max_iters=20, cg_iters=100, layout=None, rtol=rtol,
        cg_tol=1e-8)
    assert dev_hist == hist and n == len(hist) - 1


def test_tracing_off_records_nothing(problems, tracing):
    p = problems["cube"]
    tsb.sharded_lm_solve(p, None, max_iters=3, cg_iters=50)
    ts.lm_solve(p, max_iters=3)
    assert tracing.span_stats() == {} and tracing.counter_stats() == {}
    # on, the single-device dense path makes no collective and no CG
    tracing.enable()
    ts.lm_solve(p, max_iters=3)
    assert tracing.counter_stats() == {}
    assert tracing.span_stats("ba.lm")["ba.lm"]["count"] == 1


WORKER = r"""
import json, pickle, sys
import torch
import torch.distributed as dist
from mqslam_tpu_torch.ba import problem as bp, solver as ts
from mqslam_tpu_torch.parallel import multihost, sharded_ba
from mqslam_tpu_torch.utils import profiling
rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                     backend="gloo", timeout_s=60)
merged, solver = pickle.load(open(src, "rb"))
prob = bp.problem_from_ba_data(merged, pad_multiple=world, device="cpu")
seen = dict(cg=0, calls=0, bytes=0)
real_solve, real_reduce = ts.solve_delta, dist.all_reduce
def solve_delta(*a, **k):
    out = real_solve(*a, **k)
    seen["cg"] += int(out[2])
    return out
def all_reduce(x, *a, **k):
    seen["calls"] += 1
    seen["bytes"] += x.numel() * x.element_size()
    return real_reduce(x, *a, **k)
ts.solve_delta, dist.all_reduce = solve_delta, all_reduce
profiling.enable()
v, hist = sharded_ba.sharded_lm_solve(
    prob, dist.group.WORLD, max_iters=solver["max_iters"],
    cg_iters=solver["cg_iters"], cg_tol=solver["cg_tol"],
    rtol=solver["rtol"], layout=solver["layout"])
with open(dst, "w") as f:
    json.dump(dict(hist=hist, seen=seen,
                   spans={k: s["count"] for k, s in
                          profiling.span_stats("ba.sharded.").items()},
                   counters=profiling.counter_stats("ba."),
                   v=[x.tolist() for x in v]), f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fleet_solve(tmp_path_factory):
    """Three agents over 16 frames merged (the benchmark driver's traffic
    at 160 x 120) and solved over two gloo ranks: (merged dump, solver
    settings, each rank's output)."""
    sys.path.insert(0, ROOT)
    from benchmark import harness
    from benchmark.drivers import joint_refine
    spec = copy.deepcopy(harness.cell_spec("euroc_joint.joint_ba_x4"))
    cfg, tr = spec["config"], spec["workload"]["traffic"]
    cfg["camera"].update(width=160, height=120, fx=97.6, fy=97.3, cx=78.1,
                         cy=62.0)
    cfg["tracker"].update(max_tracks=64, max_landmarks=1024,
                          target_keypoints=50, ransac_hypotheses=16)
    cfg["rendezvous"]["every_frames"] = 4
    tr.update(agents=3, lap_frames=16, init_points=40)
    merged, flight = joint_refine.make_dump(cfg, tr, 2 ** 31 + 11,
                                            torch.device("cpu"))
    assert flight["rejected"] == 0 and flight["cross_factors"] == 10
    tmp = tmp_path_factory.mktemp("joint")
    with open(tmp / "dump.pkl", "wb") as f:
        pickle.dump((merged, cfg["solver"]), f)
    port = multihost.free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(port),
         str(tmp / "dump.pkl"), str(tmp / f"out{r}.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, logs[r][-3000:]
    return merged, cfg["solver"], [
        json.loads((tmp / f"out{r}.json").read_text()) for r in range(2)]


def test_spans_and_counters_over_two_gloo_ranks(fleet_solve):
    _, solver, outs = fleet_solve
    for out in outs:
        iters = len(out["hist"]) - 1
        assert 1 <= iters < solver["max_iters"]    # the rtol stop
        s, c, seen = out["spans"], out["counters"], out["seen"]
        assert s["ba.sharded.layout"] == s["ba.sharded.lm"] == 1
        assert s["ba.sharded.linearize"] == iters
        assert s["ba.sharded.cost"] == s["ba.sharded.step"] + 1
        assert c["ba.cg_iters"]["calls"] == s["ba.sharded.step"]
        assert c["ba.cg_iters"]["total"] == seen["cg"] > 0
        assert c["ba.allreduce_bytes"] == dict(calls=seen["calls"],
                                               total=seen["bytes"])
    assert outs[0]["counters"] == outs[1]["counters"]


def test_merged_fleet_reaches_the_float64_optimum(fleet_solve):
    from benchmark.reference import ba as ref, ba_joint
    merged, _, outs = fleet_solve
    assert outs[0]["v"] == outs[1]["v"] and outs[0]["hist"] == outs[1][
        "hist"]
    dev = torch.device("cpu")
    g = ref.graph_from_data(merged, dev)
    optimum = ba_joint.start_optimum(g, merged, dev)
    r, t, X = (torch.as_tensor(np.asarray(x), dtype=torch.float64)
               for x in outs[0]["v"])
    gaps = ba_joint.gaps(g, (ref.exp_so3(r), t, X), optimum)
    assert abs(gaps["cost_excess_rel"]) <= 1e-5, gaps
    assert gaps["cost_gap_rel"] <= 1e-5, gaps
    assert gaps["center_gap_m"] <= 1e-4 and gaps["rot_gap_rad"] <= 1e-4, gaps
    assert gaps["point_gap_rel"] <= 1e-3, gaps
