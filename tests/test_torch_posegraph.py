"""Pose-graph optimization (``ba/posegraph.py``) of both packages on the
same graph: ``tests/test_posegraph.py::_build_graph``'s 40-pose circle
(odometry drift plus one loop edge), carried into the port as NumPy
(``convert.pose_graph_from_numpy``), on the CPU.

Tolerances: ``pgo_cost`` 1e-5 relative; one ``_linearize`` (Jacobians in
closed form here, ``vmap(jacfwd)`` there) 1e-5 of each block's scale;
``pgo_solve`` final cost 1e-4 relative and poses 1e-3 (25 LM iterations of
60 CG iterations, float32, sums in another order).  Then the JAX tests'
criteria, held by the port: drift removed, perfect measurements exact,
masked edges and poses inert.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ba import posegraph as jpg
from test_posegraph import _build_graph

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import posegraph as tpg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small eager ops: one torch thread is as fast, and beside parallel
    test workers many threads a process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(g):
    return convert.pose_graph_from_numpy(
        {k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def _scale(x):
    """The size a float32 error is measured against: the largest entry, at
    least 1 (whitened residuals at a consistent initial guess are roundoff,
    ~1e-6)."""
    return max(float(np.abs(x).max()), 1.0)


GRAPHS = [dict(n=40, odo_noise=0.02, loop=True),
          dict(n=40, odo_noise=0.02, loop=False),
          dict(n=20, odo_noise=0.0, loop=True),
          dict(n=25, odo_noise=0.05, loop=True, seed=3)]


@pytest.mark.parametrize("kw", GRAPHS)
def test_cost_equal(kw):
    g, gt, init = _build_graph(**kw)
    tg = _port(g)
    want = float(jpg.pgo_cost(g))
    got = float(tpg.pgo_cost(tg))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-9)
    at_gt = float(tpg.pgo_cost(tg, torch.tensor(gt)))
    assert at_gt == pytest.approx(float(jpg.pgo_cost(g, jnp.asarray(gt))),
                                  rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("kw", GRAPHS[:2])
def test_linearize_equal(kw):
    g, _, _ = _build_graph(**kw)
    tg = _port(g)
    want = jpg._linearize(g, g.poses)
    got = tpg._linearize(tg, tg.poses)
    for name, w, t in zip(("Jf", "Jt", "r", "Jp", "rp"), want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, atol=1e-5 * _scale(w),
                                   err_msg=name)
    Jf, Jt, _, Jp, _ = got
    D = tpg._block_diag(tg, Jf, Jt, Jp).numpy()
    Dj = np.asarray(jpg._block_diag(g, *(jnp.asarray(x.numpy())
                                         for x in (Jf, Jt, Jp))))
    np.testing.assert_allclose(D, Dj, atol=1e-5 * _scale(Dj))
    # the matrix-free operator against the dense Gauss-Newton matrix
    rng = np.random.RandomState(1)
    v = rng.randn(*tg.poses.shape).astype(np.float32)
    diag = np.maximum(np.diagonal(D, axis1=-2, axis2=-1), 1e-8)
    Hv = tpg._make_Hv(tg, Jf, Jt, Jp, 1e-3, torch.tensor(diag))
    Hvj = jpg._make_Hv(g, *(jnp.asarray(x.numpy()) for x in (Jf, Jt, Jp)),
                       1e-3, jnp.asarray(diag))
    want_hv = np.asarray(Hvj(jnp.asarray(v)))
    np.testing.assert_allclose(Hv(torch.tensor(v)).numpy(), want_hv,
                               atol=1e-5 * _scale(want_hv))


@pytest.mark.parametrize("kw", GRAPHS)
def test_solve_equal(kw):
    g, gt, _ = _build_graph(**kw)
    tg = _port(g)
    pj, cj, lj = jpg.pgo_solve(g, iters=25)
    pt, ct, lt = tpg.pgo_solve(tg, iters=25)
    assert float(ct) == pytest.approx(float(cj), rel=1e-4, abs=1e-7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    assert float(ct) <= float(tpg.pgo_cost(tg))


def test_retract_all_equal():
    g, _, _ = _build_graph(n=12, odo_noise=0.02)
    rng = np.random.RandomState(2)
    delta = (rng.randn(12, 6) * 0.1).astype(np.float32)
    active = np.arange(12) % 3 != 0
    want = np.asarray(jpg._retract_all(g.poses, jnp.asarray(delta),
                                       jnp.asarray(active)))
    got = tpg._retract_all(torch.tensor(np.asarray(g.poses)),
                           torch.tensor(delta), torch.tensor(active))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~active],
                                  np.asarray(g.poses)[~active])


def test_loop_closure_removes_drift():
    g, gt, init = _build_graph(n=40, odo_noise=0.02, loop=True)
    tg = _port(g)
    drift0 = np.linalg.norm(init[:, 3:] - gt[:, 3:], axis=1)
    poses, cost, _ = tpg.pgo_solve(tg, iters=25)
    err = np.linalg.norm(poses.numpy()[:, 3:] - gt[:, 3:], axis=1)
    assert err.max() < 0.5 * drift0.max(), (err.max(), drift0.max())
    assert float(cost) < float(tpg.pgo_cost(tg))


def test_perfect_measurements_exact():
    g, gt, _ = _build_graph(n=20, odo_noise=0.0, loop=True)
    poses, _, _ = tpg.pgo_solve(_port(g), iters=15)
    err = np.linalg.norm(poses.numpy()[:, 3:] - gt[:, 3:], axis=1)
    assert err.max() < 1e-3, err.max()


def test_invalid_edges_and_poses_masked():
    g, gt, _ = _build_graph(n=10, odo_noise=0.01, loop=False)
    base = _port(g)
    f = {k: np.asarray(v) for k, v in g._asdict().items()}
    f["edge_i"] = np.concatenate([f["edge_i"], [0, 1]]).astype(np.int32)
    f["edge_j"] = np.concatenate([f["edge_j"], [5, 7]]).astype(np.int32)
    for k in ("edge_meas_r", "edge_meas_t"):
        f[k] = np.concatenate([f[k], np.full((2, 3), 99.0, np.float32)])
    f["edge_inv_sigma"] = np.concatenate([f["edge_inv_sigma"],
                                          np.ones((2, 6), np.float32)])
    f["edge_valid"] = np.concatenate([f["edge_valid"], np.zeros(2, bool)])
    # one more pose, invalid and unconstrained: it must pass through
    for k, fill in (("poses", 7.0), ("prior_r", 0.0), ("prior_t", 0.0),
                    ("prior_inv_sigma", 1.0)):
        f[k] = np.concatenate([f[k], np.full((1, f[k].shape[1]), fill,
                                             np.float32)])
    for k in ("pose_valid", "prior_mask"):
        f[k] = np.concatenate([f[k], np.zeros(1, bool)])
    tg = convert.pose_graph_from_numpy(f, device="cpu")
    poses, cost, _ = tpg.pgo_solve(tg, iters=10)
    ref, cost_ref, _ = tpg.pgo_solve(base, iters=10)
    assert np.isfinite(float(cost))
    assert float(cost) == pytest.approx(float(cost_ref), rel=1e-5)
    np.testing.assert_allclose(poses.numpy()[:10], ref.numpy(), atol=1e-5)
    np.testing.assert_array_equal(poses.numpy()[10], np.full(6, 7.0))
    err = np.linalg.norm(poses.numpy()[:10, 3:] - gt[:, 3:], axis=1)
    assert err.max() < 1.0


def test_pose_graph_round_trip():
    g, _, _ = _build_graph(n=8)
    f = convert.pose_graph_to_numpy(_port(g))
    assert f.keys() == g._asdict().keys()
    for k, v in g._asdict().items():
        np.testing.assert_array_equal(f[k], np.asarray(v), err_msg=k)
        assert f[k].dtype == np.asarray(v).dtype, k
