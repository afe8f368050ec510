"""Homography, triangulation and PnP of the port against the JAX package on
the CPU: the same NumPy scenes through both; the JAX RANSAC draw
``jax.random.uniform(key, (n_hyp, K))`` is handed to the port as
``scores``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.core import camera as jcam, se3 as jse3
from mqslam_tpu.ops import homography as jh, pnp as jp, triangulation as jt
from mqslam_tpu_torch.core import camera as tcam, se3 as tse3
from mqslam_tpu_torch.ops import homography as th, pnp as tp, \
    triangulation as tt

CAL9 = np.array([500.0, -480.0, 0.3, 320, 240, 0.05, -0.02, 1e-3, -2e-3],
                np.float32)
JCAL = jcam.Cal3DS2.from_array(jnp.asarray(CAL9))
TCAL = tcam.Cal3DS2.from_array(torch.tensor(CAL9))
RV = np.array([0.05, -0.1, 0.02], np.float32)
TV = np.array([0.1, -0.2, 0.3], np.float32)


def close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


@pytest.fixture
def rng():
    return np.random.RandomState(31337)


def scene(rng, K=64, planar=False, noise=0.3, outliers=8, dead=5):
    X = rng.uniform(-2, 2, (K, 3)).astype(np.float32)
    X[:, 2] = 6.0 if planar else X[:, 2] + 6
    P = jse3.from_rvec_tvec(jnp.asarray(RV), jnp.asarray(TV))
    uv = np.asarray(jcam.project(jnp.asarray(X), P, JCAL)[0])
    uv = uv + rng.randn(K, 2).astype(np.float32) * noise
    uv[:outliers] += 30
    valid = np.ones(K, bool)
    if dead:
        valid[-dead:] = False
        X[-dead:] = np.nan            # never-initialised slots
    return X, uv.astype(np.float32), valid


def two_view(rng, N=80):
    pts1 = rng.uniform(-0.5, 0.5, (N, 2))
    depth = rng.uniform(4, 6, N)
    X = np.concatenate([pts1 * depth[:, None], depth[:, None]], 1)
    P1 = np.eye(4, dtype=np.float32)
    P2 = np.asarray(jse3.from_rvec_tvec(
        jnp.asarray([0.01, 0.02, 0.005], jnp.float32),
        jnp.asarray([0.3, 0.05, 0.02], jnp.float32)))
    p2 = X @ P2[:3, :3].T + P2[:3, 3]
    pts2 = p2[:, :2] / p2[:, 2:3] + rng.randn(N, 2) * 1e-3
    return (pts1.astype(np.float32), pts2.astype(np.float32), P1, P2,
            X.astype(np.float32))


def test_homography(rng):
    """H atol 1e-4 at unit Frobenius scale; condition number rtol 1e-3 (a
    ratio of singular values from a Jacobi solve)."""
    pts1, pts2, *_ = two_view(rng)
    valid = rng.rand(80) > 0.2
    Hj = jh.fit_homography(jnp.asarray(pts1), jnp.asarray(pts2),
                           jnp.asarray(valid))
    Ht = th.fit_homography(torch.tensor(pts1), torch.tensor(pts2),
                           torch.tensor(valid))
    close(Ht, Hj, 1e-4)
    cj = float(jh.homography_condition(Hj))
    ct = float(th.homography_condition(Ht))
    assert abs(ct - cj) <= 1e-3 * cj
    assert bool(th.keyframe_test(torch.tensor(pts1), torch.tensor(pts2))) == \
        bool(jh.keyframe_test(jnp.asarray(pts1), jnp.asarray(pts2)))
    assert not bool(th.keyframe_test(torch.tensor(pts1), torch.tensor(pts1)))
    # batched = stacked
    Hb = th.fit_homography(torch.tensor(np.stack([pts1, pts1])),
                           torch.tensor(np.stack([pts2, pts1])))
    close(Hb[0], jh.fit_homography(jnp.asarray(pts1), jnp.asarray(pts2)),
          1e-4)


def test_triangulation(rng):
    """Points ~5 m away: atol 1e-3 m (the 4x4 Jacobi null vector is
    dehomogenized by a small w)."""
    pts1, pts2, P1, P2, X = two_view(rng)
    j = [jnp.asarray(a) for a in (pts1, P1, pts2, P2)]
    t = [torch.tensor(a) for a in (pts1, P1, pts2, P2)]
    close(tt.fundamental_from_P(t[1], t[3]),
          jt.fundamental_from_P(j[1], j[3]), 1e-6)
    for name in ("linear_eigen", "optimal"):
        xj, sj = getattr(jt, name)(*j)
        xt, st = getattr(tt, name)(*t)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        close(xt, xj, 1e-3)
        # 1e-3 of image noise at 5 m over a 0.3 m baseline: ~0.1 m of depth
        assert np.abs(xt.numpy() - X).max() < 0.5
    # the corrected pairs satisfy the epipolar constraint
    F = tt.fundamental_from_P(t[1], t[3])
    u1c, u2c = tt._optimal_correct(t[0], t[2], F)
    j1c, j2c = jt._optimal_correct(j[0], j[2],
                                   jt.fundamental_from_P(j[1], j[3]))
    close(u1c, j1c, 1e-6)
    close(u2c, j2c, 1e-6)
    # batched poses: [A] cameras against [A, N] points
    xb, sb = tt.optimal(torch.stack([t[0], t[0]]), torch.stack([t[1], t[1]]),
                        torch.stack([t[2], t[2]]), torch.stack([t[3], t[3]]))
    xs, _ = tt.optimal(*t)
    np.testing.assert_allclose(xb[1].numpy(), xs.numpy(), atol=1e-6)
    # depth helper
    close(tt._depth(tt._prep(t[3]), xs),
          jt._depth(jt._prep(j[3]), jnp.asarray(xs.numpy())), 1e-5)


@pytest.mark.parametrize("name", ["linear_ls", "iterative_ls"])
def test_triangulation_least_squares(rng, name):
    """The two least-squares methods (the bench's triangulation section):
    points to 1e-3 m and status equal, as the DLT methods; iterative_ls'
    int status in {1, 0, -1, -2, -3}, here with points behind a camera."""
    pts1, pts2, P1, P2, X = two_view(rng)
    pts1[:3] *= -1.0                 # mirrored: off the epipolar geometry
    j = [jnp.asarray(a) for a in (pts1, P1, pts2, P2)]
    t = [torch.tensor(a) for a in (pts1, P1, pts2, P2)]
    xj, sj = getattr(jt, name)(*j)
    xt, st = getattr(tt, name)(*t)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st.dtype == (torch.int32 if name == "iterative_ls" else torch.bool)
    close(xt, xj, 1e-3)
    assert np.abs(xt.numpy()[3:] - X[3:]).max() < 0.5
    if name == "iterative_ls":
        assert (st.numpy()[3:] == 1).all()
    # batched poses: [A] cameras against [A, N] points
    xb, _ = getattr(tt, name)(*(torch.stack([x, x]) for x in t))
    np.testing.assert_allclose(xb[1].numpy(), xt.numpy(), atol=1e-5)


@pytest.mark.parametrize("planar", [False, True])
def test_pnp_solvers(rng, planar):
    """Minimal-ish clean sets: rotations atol 1e-4, translations 1e-3 (the
    null-space solve amplifies roundoff by the conditioning of the set)."""
    X, uv, _ = scene(rng, K=12, planar=planar, noise=0.0, outliers=0, dead=0)
    uvn = np.asarray(jcam.undistort_points(jnp.asarray(uv), JCAL))
    w = np.ones(12, np.float32)
    w[-2:] = 0
    for name in ("pnp_planar", "pnp_solve") + (() if planar else
                                               ("pnp_dlt",)):
        Rj, tj = getattr(jp, name)(jnp.asarray(X), jnp.asarray(uvn),
                                   jnp.asarray(w))
        Rt, t_t = getattr(tp, name)(torch.tensor(X), torch.tensor(uvn),
                                    torch.tensor(w))
        close(Rt, Rj, 1e-4)
        close(t_t, tj, 1e-3)
    Rt, t_t = tp.pnp_solve(torch.tensor(X), torch.tensor(uvn))
    np.testing.assert_allclose(t_t.numpy(), TV, atol=2e-2)


def test_residual_jacobian_matches_jacfwd(rng):
    """The analytic Jacobian is jax.jacfwd of the JAX residual: entries
    reach ~2e3 (px per rad), rtol 1e-5 of that scale; also at zero
    rotation, where so3.exp switches to its series."""
    X, uv, valid = scene(rng)
    Xz = np.where(valid[:, None], X, 0).astype(np.float32)
    for params in (np.concatenate([RV, TV]) + 0.01,
                   np.array([0, 0, 0, 0, 0, 0.1], np.float32),
                   np.array([1e-6, 0, 0, 0, 0, 0.1], np.float32)):
        params = params.astype(np.float32)
        Jj = jax.jacfwd(jp._proj_residual)(jnp.asarray(params),
                                           jnp.asarray(Xz), jnp.asarray(uv),
                                           JCAL)
        rj = jp._proj_residual(jnp.asarray(params), jnp.asarray(Xz),
                               jnp.asarray(uv), JCAL)
        rt, Jt = tp._residual_jac(torch.tensor(params), torch.tensor(Xz),
                                  torch.tensor(uv), TCAL)
        scale = float(np.abs(np.asarray(Jj)).max())
        close(Jt, Jj, 1e-5 * scale)
        close(rt, rj, 1e-3)


def test_pnp_refine_and_reprojection_error(rng):
    X, uv, valid = scene(rng, outliers=0)
    args_j = (jnp.asarray(X), jnp.asarray(uv), JCAL, jnp.asarray(RV + 0.02),
              jnp.asarray(TV - 0.05))
    args_t = (torch.tensor(X), torch.tensor(uv), TCAL,
              torch.tensor(RV + 0.02), torch.tensor(TV - 0.05))
    rj, tj = jp.pnp_refine(*args_j, valid=jnp.asarray(valid), iters=20)
    rt, t_t = tp.pnp_refine(*args_t, valid=torch.tensor(valid), iters=20)
    close(rt, rj, 1e-5)
    close(t_t, tj, 1e-5)
    np.testing.assert_allclose(rt.numpy(), RV, atol=5e-3)
    Xz = np.where(valid[:, None], X, 0).astype(np.float32)
    ej, pj = jp.reprojection_error(jnp.asarray(Xz), jnp.asarray(uv), JCAL,
                                   rj, tj, valid=jnp.asarray(valid))
    et, pt = tp.reprojection_error(torch.tensor(Xz), torch.tensor(uv), TCAL,
                                   rt, t_t, valid=torch.tensor(valid))
    close(et, ej, 1e-4)
    close(pt, pj, 1e-3)
    ej2, _ = jp.reprojection_error(jnp.asarray(Xz), jnp.asarray(uv), JCAL,
                                   rj, tj)
    et2, _ = tp.reprojection_error(torch.tensor(Xz), torch.tensor(uv), TCAL,
                                   rt, t_t)
    close(et2, ej2, 1e-2)
    # batched refine = per-set refine
    rb, tb = tp.pnp_refine(torch.stack([args_t[0]] * 2),
                           torch.stack([args_t[1]] * 2), TCAL,
                           torch.stack([args_t[3], args_t[3] * 0.5]),
                           torch.stack([args_t[4]] * 2),
                           valid=torch.tensor(np.stack([valid, valid])),
                           iters=20)
    np.testing.assert_allclose(rb[0].numpy(), rt.numpy(), atol=1e-6)
    np.testing.assert_allclose(tb[1].numpy(), t_t.numpy(), atol=1e-4)


@pytest.mark.parametrize("seed", [5, 6])
def test_pnp_ransac_with_jax_draws(rng, seed):
    """Same draws, same minimal sets, same winner: inlier masks equal,
    poses atol 1e-5."""
    X, uv, valid = scene(rng)
    key = jax.random.PRNGKey(seed)
    scores = np.asarray(jax.random.uniform(key, (128, 64)))
    rj, tj, mj, nj = jp.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), JCAL,
                                   jnp.asarray(valid), key)
    rt, t_t, mt, nt = tp.pnp_ransac(torch.tensor(X), torch.tensor(uv), TCAL,
                                    torch.tensor(valid),
                                    scores=torch.tensor(scores))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(nt) == int(nj) >= 45
    close(rt, rj, 1e-5)
    close(t_t, tj, 1e-5)
    assert not mt.numpy()[:8].any() and not mt.numpy()[-5:].any()


def test_pnp_ransac_batched_and_generator(rng):
    X, uv, valid = scene(rng)
    key = jax.random.PRNGKey(9)
    sc = np.asarray(jax.random.uniform(key, (2, 128, 64)))
    args = (torch.tensor(np.stack([X, X])), torch.tensor(np.stack([uv, uv])),
            TCAL, torch.tensor(np.stack([valid, valid])))
    rb, tb, mb, nb = tp.pnp_ransac(*args, scores=torch.tensor(sc))
    for a in range(2):
        r1, t1, m1, n1 = tp.pnp_ransac(torch.tensor(X), torch.tensor(uv),
                                       TCAL, torch.tensor(valid),
                                       scores=torch.tensor(sc[a]))
        np.testing.assert_array_equal(mb[a].numpy(), m1.numpy())
        np.testing.assert_allclose(rb[a].numpy(), r1.numpy(), atol=1e-6)
    # drawn from a generator: reproducible, and still finds the pose
    outs = [tp.pnp_ransac(*args, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_allclose(outs[0][0][0].numpy(), RV, atol=5e-3)
