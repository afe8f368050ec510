"""``cli/ba_run.py::refine`` (mode 0: LM, then the float64 polish) against
the plain float64 reference ``benchmark/reference/ba.py`` on the CPU, the
reference's factors against ``ba/factors.py``'s, ``refine`` against
``run``, and the solver's spans.

Tolerances: factor residuals and Jacobians 1e-9 relative and absolute
(both float64, the same functions written twice); the reference's graph
against the program's problem 2e-4 in whitened residuals (the program
rounds its inputs to float32); a refine of the cube (2 robots, 40 poses)
and of the ICL dump's first 30 steps, each from a seeded jittered start,
within 1e-5 relative in cost and 1e-5 m / 1e-5 rad in centres and
rotations of the float64 optimum the reference reaches from the refine's
answer: the polish walks the valley in float64, but on the float32 inputs
and hands back float32 values, which sit about 1e-7 from it (1.5e-7 m,
2.9e-7 rad, 4e-7 relative in cost on the ICL prefix); a refine without the
polish sits farther.  torch runs on one thread here."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark.drivers import ba_refine as drv
from benchmark.reference import ba as ref
from mqslam_tpu_torch.ba import factors, problem as bp
from mqslam_tpu_torch.ba import solver as bs, synthetic as bsyn
from mqslam_tpu_torch.cli import ba_run
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.io import ba_info
from mqslam_tpu_torch.utils import profiling

ICL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "icl_r5b")
JITTER = dict(center_m=0.002, rotation_rad=0.001, point_m=0.002)


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


def jittered(data, seed):
    """``data`` with its estimates jittered: rotations turned by Exp of
    N(0, rotation_rad) in the body frame, centres and landmarks moved by
    N(0, center_m) and N(0, point_m); measurements and priors as given."""
    R, c, X = (x.numpy() for x in ref.variables_from_data(data, "cpu"))
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, JITTER["rotation_rad"], c.shape)
    c = c + rng.normal(0.0, JITTER["center_m"], c.shape)
    X = X + rng.normal(0.0, JITTER["point_m"], X.shape)
    R = R @ ref.exp_so3(torch.as_tensor(w)).numpy()
    S = len(data.point3D_added_idxs)
    poses = []
    for cam, nodes in enumerate(data.poses):
        out = []
        for f, node in enumerate(nodes):
            if node is not None:
                W = np.eye(4)
                W[:3, :3], W[:3, 3] = R[cam * S + f], c[cam * S + f]
                node = (W, node[1])
            out.append(node)
        poses.append(out)
    return dataclasses.replace(data, poses=poses, points3D=X)


@pytest.fixture(scope="module")
def datasets():
    icl = drv.prefix(ba_info.load_ba_data(ICL, "mqslam", 1, 30), 30)
    return {"cube": jittered(bsyn.generate_cube_scenario(nr_cameras=2), 3),
            "icl30": jittered(icl, 4)}


def answer(v):
    return (ref.exp_so3(v.pose_r.double()), v.pose_t.double(),
            v.points.double())


@pytest.mark.parametrize("which", ["cube", "icl30"])
def test_refine_reaches_the_float64_optimum(datasets, which):
    data = datasets[which]
    v, hist, hist64 = ba_run.refine(data, device="cpu")
    assert hist[-1] < hist[0] and hist64[-1] <= hist64[0]
    optimum = ref.start_optimum(data, "cpu")
    r = ref.gaps(data, answer(v), "cpu", optimum)
    # no higher than the float64 LM from the same start
    assert r["cost_excess_rel"] <= 1e-5, r
    assert r["cost_gap_rel"] <= 1e-5, r
    assert r["center_gap_m"] <= 1e-5, r
    assert r["rot_gap_rad"] <= 1e-5, r
    # the same refine without the polish sits farther from the optimum
    v32, _ = bs.lm_solve(bp.problem_from_ba_data(data, device="cpu"))
    r32 = ref.gaps(data, answer(v32), "cpu", optimum)
    assert max(r32["center_gap_m"], r32["cost_gap_rel"]) > max(
        r["center_gap_m"], r["cost_gap_rel"]), (r, r32)


KINDS = ["projection", "odometry", "pose_prior", "point_prior"]
REF_NAME = dict(projection="obs_residual", odometry="odo_residual",
                pose_prior="pose_prior_residual",
                point_prior="point_prior_residual")


@pytest.mark.parametrize("kind", KINDS)
def test_reference_factors_match_the_program(kind):
    """Each kind's residual and Jacobians in float64 at seeded random
    poses (rotations of ~1 rad), landmarks, measurements and sigmas: the
    reference's functions, differentiated by ``torch.func``, against
    ``ba/factors.py``'s closed forms (the point prior's is the solver's
    own line, (X - X_p) / sigma)."""
    gen = torch.Generator().manual_seed(11 + KINDS.index(kind))
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    n = 16
    p6, q6 = rnd(n, 6), rnd(n, 6)
    p6[:, 3:] *= 0.2
    X = rnd(n, 3) + torch.tensor([0.0, 0.0, 4.0], dtype=torch.float64)
    w6, z6 = 1.0 + rnd(n, 6).abs(), torch.zeros(n, 6, dtype=torch.float64)
    E = lambda v: so3.exp(v[:, :3])
    jac = torch.func.jacfwd
    if kind == "projection":
        cal = torch.tensor([480.0, -470.0, 0.5, 320.0, 240.0, -0.1, 0.02,
                            1e-3, -2e-3], dtype=torch.float64).expand(n, 9)
        uv, w = rnd(n, 2) * 50 + 300, 1.0 + rnd(n).abs()
        mine = [factors.obs_residual(p6, X, uv, cal, w[:, None]),
                *factors.obs_residual_jac(p6, X, uv, cal, w[:, None])]
        args = (z6, z6[:, :3], E(p6), p6[:, 3:], X, uv, cal, w)
        theirs = [torch.vmap(ref.obs_residual)(*args), *torch.vmap(
            jac(ref.obs_residual, argnums=(0, 1)))(*args)]
    elif kind == "odometry":
        mr, mt = 0.2 * rnd(n, 3) + p6[:, :3] - q6[:, :3], rnd(n, 3)
        mine = [factors.odo_residual(p6, q6, mr, mt, w6),
                *factors.odo_residual_jac(p6, q6, mr, mt, w6)]
        args = (z6, z6, E(p6), p6[:, 3:], E(q6), q6[:, 3:], E(mr), mt, w6)
        theirs = [torch.vmap(ref.odo_residual)(*args), *torch.vmap(
            jac(ref.odo_residual, argnums=(0, 1)))(*args)]
    elif kind == "pose_prior":
        pr, pt = p6[:, :3] + 0.1 * rnd(n, 3), rnd(n, 3)
        mine = [factors.prior_pose_residual(p6, pr, pt, w6),
                factors.prior_pose_residual_jac(p6, pr, pt, w6)]
        args = (z6, E(p6), p6[:, 3:], E(pr), pt, w6)
        theirs = [torch.vmap(ref.pose_prior_residual)(*args),
                  torch.vmap(jac(ref.pose_prior_residual))(*args)]
    else:
        Xp, w = X + rnd(n, 3), w6[:, :3]
        mine = [(X - Xp) * w, torch.diag_embed(w)]
        args = (z6[:, :3], X, Xp, w)
        theirs = [torch.vmap(ref.point_prior_residual)(*args),
                  torch.vmap(jac(ref.point_prior_residual))(*args)]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_graph_matches_the_problem(kind):
    """The reference's graph of the cube takes the factors the program's
    ``problem_from_ba_data`` takes, in its order: each kind's residuals
    at the start turned and moved at random agree to the float32 rounding
    of the program's inputs (pixels ~6e-5, rotation logs ~1e-7 rad, over
    sigmas of 1 px, 0.02 rad and 0.05 rad)."""
    data = bsyn.generate_cube_scenario(nr_cameras=2, seed=7)
    prob = bp.problem_to(bp.problem_from_ba_data(data, device="cpu"), "cpu",
                         torch.float64)
    g = ref.graph_from_data(data, "cpu")
    gen = torch.Generator().manual_seed(17)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    v = bp.BAVariables(prob.init.pose_r + 0.3 * rnd(prob.n_poses, 3),
                       prob.init.pose_t + 0.1 * rnd(prob.n_poses, 3),
                       prob.init.points + 0.05 * rnd(prob.n_points, 3))
    mine = dict(zip(KINDS, bs._residuals(prob, v)))[kind]
    valid = dict(zip(KINDS, (prob.obs_valid, prob.odo_valid,
                             prob.prior_pose_valid,
                             prob.prior_point_valid)))[kind]
    theirs = {fn.__name__: torch.vmap(fn)(*inc, *args) for fn, inc, args, _
              in ref._factors(g, so3.exp(v.pose_r), v.pose_t, v.points)}
    theirs = theirs[REF_NAME[kind]]
    assert int(valid.sum()) == len(theirs) > 0
    np.testing.assert_allclose(mine[valid].numpy(), theirs.numpy(), rtol=0,
                               atol=2e-4)


def test_refine_is_what_run_solves(tmp_path):
    """``run`` (mode 0, the cube) returns ``refine``'s result bit for bit
    and writes it."""
    v_run, h_run = ba_run.run(str(tmp_path), "cube", 2, 1,
                              run_from_generated=True, verbose=False,
                              device="cpu")
    v, h, h64 = ba_run.refine(bsyn.generate_cube_scenario(nr_cameras=2),
                              device="cpu")
    assert h + h64[1:] == h_run
    for a, b in zip(v, v_run):
        assert torch.equal(a, b)
    assert (tmp_path / "map_out-cube-BA.pcd").exists()


def test_spans_count_the_solver_and_change_nothing(tracing, monkeypatch,
                                                   datasets):
    """With tracing on, one refine records ``ba.build``, ``ba.lm`` and
    ``ba.polish64`` once, ``ba.linearize`` once an LM outer iteration,
    ``ba.step`` once an attempt and ``ba.cost`` once an attempt and once
    for the start; its outputs are those of a refine with tracing off."""
    data = datasets["icl30"]
    v_off, *h_off = ba_run.refine(data, device="cpu")
    assert tracing.span_stats("ba.") == {}
    attempts = [0]
    real_apply = bs.apply_delta

    def apply_delta(*a, **k):
        attempts[0] += 1
        return real_apply(*a, **k)
    monkeypatch.setattr(bs, "apply_delta", apply_delta)
    tracing.enable()
    v_on, *h_on = ba_run.refine(data, device="cpu")
    tracing.disable()
    s = tracing.span_stats("ba.")
    assert h_on == h_off
    for a, b in zip(v_on, v_off):
        assert torch.equal(a, b)
    iters = len(h_on[0]) - 1
    assert {k: v["count"] for k, v in s.items()} == {
        "ba.build": 1, "ba.lm": 1, "ba.polish64": 1, "ba.linearize": iters,
        "ba.step": attempts[0], "ba.cost": attempts[0] + 1}
    assert attempts[0] >= iters > 0
    inside = sum(s[k]["host_ms"] for k in ("ba.linearize", "ba.step",
                                           "ba.cost"))
    assert inside <= s["ba.lm"]["host_ms"]
