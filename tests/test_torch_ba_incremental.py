"""mqslam_tpu_torch.ba.incremental against mqslam_tpu.ba.incremental on the
CPU: the activation steps, and the step-batched incremental solve on the
in-repo ICL dump (the first 20 steps of its 200, the dense path) and on
the 2-robot cube (the whole schedule, the CG path over COO).  Both
packages solve the identical problem (the JAX problem is carried across
field by field).

What can be held: the schedule carries lambda from step to step, and near
a step's minimum whether an attempt lowers the float32 cost is decided by
its last bits, so one package may accept where the other rejects and the
two then run with lambdas orders of magnitude apart for a few steps.  The
JAX package's own host and device loops disagree so: their per-step costs
differ by up to 29 % on the cube and 10 % on the ICL prefix.  The
solution after the final step's full LM is held: cube cost 1e-4 relative
and camera centres 2e-4 m (measured 1.3e-6 and 8.4e-5 m; the port is
5.4e-6 m from a float64 run of itself, the JAX package 8.1e-5 m), ICL
prefix centres 1e-4 m (measured 2.2e-5; the JAX package's two loops
2.8e-5) and per-step costs 0.25 relative (measured 0.092).  Activation
steps equal; ``incremental_solve_device`` equal to the host loop it
wraps; ``incremental_lockstep``, which takes that chaos out of a
comparison of two copies, runs its first copy as ``incremental_solve``
does and holds a float64 copy to 1e-3 relative per step and 1e-4 m.  torch runs on one thread here so that its sums have one order."""

import os

import numpy as np
import pytest
import torch

from mqslam_tpu.ba import incremental as jinc, problem as jp
from mqslam_tpu.ba import synthetic as jsyn
from mqslam_tpu.io import ba_info as jio
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import incremental as tinc, synthetic as tsyn
from mqslam_tpu_torch.io import ba_info as tio

ICL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "icl_r5b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_fields(J):
    f = {k: np.asarray(v) for k, v in J._asdict().items() if k != "init"}
    f["init"] = {k: np.asarray(v) for k, v in J.init._asdict().items()}
    return f


@pytest.fixture(scope="module")
def problems():
    """(JAX BAData, port BAData, JAX problem, port problem) per case."""
    out = {}
    for which in ("icl", "cube"):
        if which == "icl":
            jd = jio.load_ba_data(ICL, "mqslam", 1, 30)
            td = tio.load_ba_data(ICL, "mqslam", 1, 30)
        else:
            jd = jsyn.generate_cube_scenario(nr_cameras=2)
            td = tsyn.generate_cube_scenario(nr_cameras=2)
        J = jp.problem_from_ba_data(jd)
        out[which] = (jd, td, J,
                      convert.problem_from_numpy(jax_fields(J), "cpu"))
    return out


@pytest.mark.parametrize("which", ["icl", "cube"])
def test_activation_steps(problems, which):
    jd, td, J, T = problems[which]
    steps = tinc.activation_steps(td, T)
    for a, t in zip(jinc.activation_steps(jd, J), steps):
        assert t.dtype == torch.int32 and t.device == T.device
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    # every valid observation enters at a step of the schedule
    assert (steps[0][T.obs_valid] < td.nr_steps).all()


def hold(vt, vj, ht, hj, hist_rtol, centres_m):
    assert len(ht) == len(hj) and np.isfinite(ht).all()
    np.testing.assert_allclose(ht, hj, rtol=hist_rtol)
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               atol=centres_m)


@pytest.fixture(scope="module")
def icl_runs(problems):
    jd, td, J, T = problems["icl"]
    return (jinc.incremental_solve(jd, J, max_steps=20),
            tinc.incremental_solve(td, T, max_steps=20))


def test_incremental_icl_dense(problems, icl_runs):
    """20 steps of the ICL dump (F = 200 poses, dense): step 1 is the
    second landmark batch (a full LM), step 19 the last."""
    (vj, hj), (vt, ht) = icl_runs
    hold(vt, vj, ht, hj, 0.25, 1e-4)
    assert len(ht) == 20
    T = problems["icl"][3]
    # poses not yet active keep their initial values
    np.testing.assert_array_equal(vt.pose_t[20:].numpy(),
                                  T.init.pose_t[20:].numpy())


def test_incremental_cube_cg(problems):
    """The whole cube schedule over CG (100 iterations a solve): the final
    step's full LM reaches the JAX package's solution."""
    jd, td, J, T = problems["cube"]
    vj, hj = jinc.incremental_solve(jd, J, method="cg", cg_iters=100)
    vt, ht = tinc.incremental_solve(td, T, method="cg", cg_iters=100)
    assert len(ht) == len(hj) == jd.nr_steps and np.isfinite(ht).all()
    assert ht[-1] == pytest.approx(hj[-1], rel=1e-4)
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               atol=2e-4)


def test_incremental_device_is_the_host_loop(problems):
    """``incremental_solve_device`` wraps the host loop and passes
    ``max_retries`` / ``cg_tol`` through; its history is one cost a step,
    as the JAX device loop's."""
    jd, td, J, T = problems["cube"]
    kw = dict(method="cg", cg_iters=60, cg_tol=1e-4, max_retries=2,
              max_steps=6)
    vh, hh = tinc.incremental_solve(td, T, **kw)
    vd, hd = tinc.incremental_solve_device(td, T, **kw)
    assert hd == hh and torch.equal(vd.pose_t, vh.pose_t)
    assert len(jinc.incremental_solve_device(jd, J, **kw)[1]) == len(hd) == 6
    vh3, _ = tinc.incremental_solve(td, T, **dict(kw, max_retries=3))
    assert not torch.equal(vh3.pose_t, vh.pose_t)


@pytest.mark.parametrize("method,kw", [
    ("dense", {}), ("cg", dict(cg_iters=100, max_steps=8))])
def test_lockstep(problems, method, kw):
    """The cube's schedule in lockstep with a float64 copy of itself: the
    first copy runs as ``incremental_solve`` runs it, bit for bit, and with
    the accept decisions shared the float64 copy's per-step costs lie
    within 1e-3 relative and its camera centres within 1e-4 m (measured
    1.4e-5 / 4.5e-6 m dense, 2.6e-6 / 7.6e-6 m over the whole schedule by
    CG)."""
    from mqslam_tpu_torch.ba import problem as tp
    jd, td, J, T = problems["cube"]
    v, h = tinc.incremental_solve(td, T, method=method, **kw)
    (v32, v64), (h32, h64) = tinc.incremental_lockstep(
        td, [T, tp.problem_to(T, "cpu", torch.float64)], method=method,
        **kw)
    assert h32 == h and torch.equal(v32.pose_t, v.pose_t)
    assert len(h64) == len(h) == kw.get("max_steps", td.nr_steps)
    np.testing.assert_allclose(h64, h32, rtol=1e-3)
    np.testing.assert_allclose(v64.pose_t.numpy(), v32.pose_t.numpy(),
                               atol=1e-4)
