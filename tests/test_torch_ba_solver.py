"""mqslam_tpu_torch.ba (problem, solver, polish64, validate) against
mqslam_tpu.ba on the CPU.  Two problems: the synthetic 2-robot cube and the
in-repo ICL dump cut to its first 40 steps (40 poses, 907 observations).
The LM tests solve the identical problem in both packages: the JAX problem
is carried across field by field (``convert.problem_from_numpy``).

Tolerances: problem fields equal, floats to 1e-6 (float32 rotation logs
from both backends); one LM step 1e-4 relative (float32 sums in another
order, a float32 Cholesky), where float32 resolves it (``as_accurate``:
otherwise as close to a float64 reference as the JAX package); whole
solves: final cost 1e-4 relative, camera
centres 1e-4 m, landmarks with at least 3 observations 1e-3 m.  The
iterations of a whole solve are counted with ``rtol=1e-5``: near the
minimum LM keeps accepting steps that lower the float32 cost by its last
bits, and how many it finds depends on the order each backend sums the
residuals, not on the solver; the cost and the centres are held at
``rtol=0``.  torch runs on one thread here so that its sums have one
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ba import polish64 as jpol, problem as jp, solver as js
from mqslam_tpu.ba import synthetic as jsyn, validate as jval
from mqslam_tpu.io import ba_info as jio
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import packed as tpk, polish64 as tpol, problem as tp
from mqslam_tpu_torch.ba import solver as ts, synthetic as tsyn
from mqslam_tpu_torch.ba import validate as tval
from mqslam_tpu_torch.io import ba_info as tio

ICL = "artifacts/icl_r5b"


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


def load(which):
    """(JAX BAData, port BAData, problem_from_ba_data kwargs)."""
    if which == "cube":
        return (jsyn.generate_cube_scenario(nr_cameras=2),
                tsyn.generate_cube_scenario(nr_cameras=2), {})
    import os
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ICL)
    return (jio.load_ba_data(root, "mqslam", 1, 30),
            tio.load_ba_data(root, "mqslam", 1, 30), {"step_limit": 40})


@pytest.fixture(scope="module")
def problems():
    out = {}
    for which in ("cube", "icl40"):
        jd, td, kw = load(which)
        J = jp.problem_from_ba_data(jd, **kw)
        out[which] = dict(jd=jd, td=td, kw=kw, J=J,
                          T=convert.problem_from_numpy(jax_fields(J), "cpu"))
    return out


@pytest.fixture(scope="module")
def solves(problems):
    """Both packages' lm_solve and lm_solve_device on both problems."""
    out = {}
    for which, p in problems.items():
        out[which] = dict(
            jax=js.lm_solve(p["J"]), port=ts.lm_solve(p["T"]),
            jax_dev=js.lm_solve_device(p["J"]),
            port_dev=ts.lm_solve_device(p["T"]))
    return out


@pytest.mark.parametrize("which", ["cube", "icl40"])
def test_problem_from_ba_data(problems, which):
    p = problems[which]
    T = tp.problem_from_ba_data(p["td"], device="cpu", **p["kw"])
    J = p["J"]
    assert T.n_poses == J.n_poses and T.n_points == J.n_points
    if which == "icl40":
        assert (J.n_poses, int(J.obs_valid.sum())) == (40, 907)
    for k, j in jax_fields(J).items():
        pairs = (j.items() if k == "init" else [(k, j)])
        for name, a in pairs:
            t = getattr(T.init if k == "init" else T, name).numpy()
            assert t.dtype == a.dtype and t.shape == a.shape, name
            if a.dtype.kind == "f":
                np.testing.assert_allclose(t, a, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(t, a, err_msg=name)
    # O, Q and Rq pad to multiples of 128 and the pads are inert
    for f in ("obs_valid", "odo_valid", "prior_point_valid"):
        n = getattr(T, f).shape[0]
        assert n % 128 == 0
    assert float(T.obs_uv[~T.obs_valid].abs().sum()) == 0.0


def test_problem_step_limit_and_device(problems):
    jd, td, _ = load("icl40")
    for S in (1, 7):
        J = jp.problem_from_ba_data(jd, step_limit=S)
        T = tp.problem_from_ba_data(td, step_limit=S, device="cpu")
        assert T.n_poses == J.n_poses == S
        assert int(T.obs_valid.sum()) == int(J.obs_valid.sum())
    assert T.device == torch.device("cpu")
    moved = tp.problem_to(T, "meta")
    assert moved.obs_uv.device.type == "meta" and \
        moved.init.points.device.type == "meta"
    wide = tp.problem_to(T, "cpu", torch.float64)
    assert wide.obs_uv.dtype == wide.init.points.dtype == torch.float64
    assert wide.obs_pose.dtype == torch.int32 and \
        wide.obs_valid.dtype == torch.bool


def as_accurate(t, j, ref, name):
    """The port's float32 ``t`` agrees with the JAX package's ``j`` to 1e-4
    relative, or is at least as close to the float64 ``ref`` (within twice
    the JAX error): at the ICL dump's first linearization the gradient is a
    sum of terms up to 300x larger than itself, each carrying a residual
    accurate to 2.5e-4 px in float32, so both packages' pose gradients and
    steps are that far from float64 (4e-3 relative for the pose step)."""
    t, j, ref = (np.asarray(x, np.float64) for x in (t, j, ref))
    scale = np.abs(ref).max()
    err_t, err_j = np.abs(t - ref).max(), np.abs(j - ref).max()
    assert (np.abs(t - j).max() <= 1e-4 * scale
            or err_t <= 2 * err_j), (name, err_t, err_j, scale)


@pytest.mark.parametrize("which", ["cube", "icl40"])
def test_one_lm_step(problems, which):
    J, T = problems[which]["J"], problems[which]["T"]
    T64 = tp.problem_to(T, "cpu", torch.float64)
    lam = 1e-3
    lj, lt = js.linearize(J, J.init), ts.linearize(T, T.init)
    l64 = ts.linearize(T64, T64.init)
    for k in ("r_obs", "J_obs_pose", "J_obs_point", "r_odo", "J_odo_from",
              "J_odo_to", "J_pp", "g_point", "Hpp", "diag_pose"):
        a, t = np.asarray(getattr(lj, k)), getattr(lt, k).numpy()
        assert t.dtype == np.float32, k
        np.testing.assert_allclose(t, a, atol=1e-4 * max(np.abs(a).max(),
                                                         1e-6), err_msg=k)
    as_accurate(lt.g_pose, lj.g_pose, l64.g_pose, "g_pose")
    for k in ("pose_free", "point_free"):
        np.testing.assert_array_equal(getattr(lt, k).numpy(),
                                      np.asarray(getattr(lj, k)))
    assert float(lt.cost) == pytest.approx(float(lj.cost), rel=1e-5)
    dcj, dpj = js.solve_delta_dense(J, lj, jnp.float32(lam))
    dct, dpt = ts.solve_delta_dense(T, lt, lam)
    dc64, dp64 = ts.solve_delta_dense(T64, l64, lam)
    assert dct.dtype == torch.float32 and dc64.dtype == torch.float64
    as_accurate(dct, dcj, dc64, "delta_pose")
    as_accurate(dpt, dpj, dp64, "delta_point")
    # apply_delta and compute_cost on the same (the JAX package's) step
    vj = js.apply_delta(J.init, dcj, dpj)
    vt = ts.apply_delta(T.init, torch.tensor(np.asarray(dcj)),
                        torch.tensor(np.asarray(dpj)))
    for k in ("pose_r", "pose_t", "points"):
        np.testing.assert_allclose(getattr(vt, k).numpy(),
                                   np.asarray(getattr(vj, k)), atol=1e-6)
    assert float(ts.compute_cost(T, vt)) == pytest.approx(
        float(js.compute_cost(J, vj)), rel=1e-5)
    # and each package's own step lowers the cost alike
    c_own = float(ts.compute_cost(T, ts.apply_delta(T.init, dct, dpt)))
    assert c_own == pytest.approx(float(js.compute_cost(J, vj)), rel=1e-3)
    assert c_own < float(lt.cost)


def well_constrained(J):
    op = np.asarray(J.obs_point)[np.asarray(J.obs_valid)]
    return np.asarray(J.point_valid) & (
        np.bincount(op, minlength=J.n_points) >= 3)


def hold_solution(problems, which, vt, vj, ht, hj):
    assert ht[-1] == pytest.approx(hj[-1], rel=1e-4)
    assert ht[-1] < ht[0]
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               atol=1e-4)
    m = well_constrained(problems[which]["J"])
    assert m.sum() >= 8
    np.testing.assert_allclose(vt.points.numpy()[m],
                               np.asarray(vj.points)[m], atol=1e-3)


@pytest.mark.parametrize("which", ["cube", "icl40"])
def test_lm_solve(problems, solves, which):
    (vj, hj), (vt, ht) = solves[which]["jax"], solves[which]["port"]
    hold_solution(problems, which, vt, vj, ht, hj)
    J, T = problems[which]["J"], problems[which]["T"]
    _, hj5 = js.lm_solve(J, rtol=1e-5)
    _, ht5 = ts.lm_solve(T, rtol=1e-5)
    assert abs(len(ht5) - len(hj5)) <= 1, (hj5, ht5)


@pytest.mark.parametrize("which", ["cube", "icl40"])
def test_lm_solve_device(problems, solves, which):
    """The device loop's entry point against the JAX package's device loop,
    and against the port's host loop, which it wraps: its contract
    (v, history, n_iters) over the same solution."""
    vj, hj, nj = solves[which]["jax_dev"]
    vt, ht, nt = solves[which]["port_dev"]
    assert nt == len(ht) - 1 and isinstance(ht[-1], float)
    hold_solution(problems, which, vt, vj, ht, hj)
    vh, hh = solves[which]["port"]
    np.testing.assert_allclose(vt.pose_t.numpy(), vh.pose_t.numpy(),
                               atol=1e-4)
    assert ht[-1] == pytest.approx(hh[-1], rel=1e-5)


def test_failed_factorization_is_a_rejected_step(problems, monkeypatch):
    """``cholesky_ex`` reporting failure turns the step into NaN, as XLA's
    Cholesky returns NaN; LM rejects it, raises lambda and goes on."""
    J, T = problems["cube"]["J"], problems["cube"]["T"]
    lt = ts.linearize(T, T.init)
    # an indefinite system: both packages give a NaN pose step
    dct, _ = ts.solve_delta_dense(T, lt, -50.0)
    dcj, _ = js.solve_delta_dense(J, js.linearize(J, J.init),
                                  jnp.float32(-50.0))
    assert torch.isnan(dct).any() and np.isnan(np.asarray(dcj)).any()
    real = torch.linalg.cholesky_ex
    calls = []

    def failing_first(A, **kw):
        L, info = real(A, **kw)
        calls.append(1)
        return L, info + (1 if len(calls) == 1 else 0)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing_first)
    lams = []
    real_solve = ts.solve_delta_dense
    monkeypatch.setattr(ts, "solve_delta_dense",
                        lambda p, l, lam: lams.append(float(lam))
                        or real_solve(p, l, lam))
    v, hist = ts.lm_solve(T, max_iters=3)
    assert lams[:2] == [pytest.approx(1e-6), pytest.approx(8e-6)]
    assert hist[1] < hist[0] and np.isfinite(hist).all()
    calls.clear()
    lams.clear()
    v, hist, n = ts.lm_solve_device(T, max_iters=3)
    assert lams[:2] == [pytest.approx(1e-6), pytest.approx(8e-6)]
    assert hist[1] < hist[0] and np.isfinite(hist).all()


def test_refusals(problems):
    """The JAX package's ``axis_name`` is the port's ``group``: a
    single-device layout in a solve over a group is refused (it holds
    every rank's rows), before any collective; a problem past the dense
    gates takes the CG path; an unknown method or layout name is
    refused."""
    T = problems["cube"]["T"]
    with pytest.raises(TypeError, match="axis_name"):
        ts.linearize(T, T.init, axis_name="x")
    lin = ts.linearize(T, T.init)
    ids = (T.obs_pose, T.obs_point, T.obs_valid, T.n_poses, T.n_points)
    with pytest.raises(ValueError, match="single-device"):
        ts.solve_delta(T, lin, 1e-3, group="group",
                       layout=tpk.build_packed_layout(*ids))
    for kw in ({"method": "qr"}, {"method": "cg", "layout": "packed"}):
        with pytest.raises(ValueError, match="'auto'"):
            ts.lm_solve(T, **kw)
    assert ts.dense_method_ok(T) == js.dense_method_ok(problems["cube"]["J"])
    big = T._replace(init=T.init._replace(
        pose_r=torch.zeros(700, 3), pose_t=torch.zeros(700, 3)))
    assert not ts.dense_method_ok(big)
    assert ts._resolve_method(big, "auto") == "cg"
    assert ts._resolve_method(T, "auto") == "dense"
    assert ts.ba_solve is ts.lm_solve


@pytest.mark.parametrize("which", ["cube", "icl40"])
def test_polish64(problems, solves, which):
    """polish64 is float64 NumPy in both packages: from the same float32
    start the costs agree to 1e-9 relative and the variables to 1e-6."""
    J, T = problems[which]["J"], problems[which]["T"]
    vj0 = solves[which]["jax"][0]
    vt0 = convert.variables_from_numpy(
        {k: np.asarray(x) for k, x in vj0._asdict().items()}, "cpu")
    vj, hj = jpol.polish64(J, vj0, max_iters=4)
    vt, ht = tpol.polish64(T, vt0, max_iters=4)
    assert len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=1e-9)
    assert vt.pose_r.dtype == torch.float32
    assert vt.pose_t.device == T.init.pose_t.device
    for k, a in convert.variables_to_numpy(vt).items():
        np.testing.assert_allclose(a, np.asarray(getattr(vj, k)), atol=1e-6)


@pytest.mark.parametrize("which", ["cube", "icl40"])
def test_validate(problems, which):
    jd, td = problems[which]["jd"], problems[which]["td"]
    assert tval.validate_data_integrity(td) is jval.validate_data_integrity(
        jd) is True
    wt, wj = [], []
    assert tval.validate_sufficiently_constrained(
        td, warn=wt.append) == jval.validate_sufficiently_constrained(
        jd, warn=wj.append)
    assert wt == wj
    td.point2D3D_assocs[0][1] = np.concatenate(
        [td.point2D3D_assocs[0][1], td.point2D3D_assocs[0][1][:1]])
    with pytest.raises(tval.ValidationError, match="duplicate"):
        tval.validate_data_integrity(td)


def test_convert_round_trip(problems):
    J = problems["icl40"]["J"]
    f = jax_fields(J)
    T = convert.problem_from_numpy(f, "cpu")
    assert T.obs_pose.dtype == torch.int32 and T.obs_valid.dtype == torch.bool
    back = convert.variables_to_numpy(T.init)
    for k, a in f["init"].items():
        np.testing.assert_array_equal(back[k], a)
    f.pop("odo_to")
    with pytest.raises(KeyError, match="odo_to"):
        convert.problem_from_numpy(f, "cpu")
