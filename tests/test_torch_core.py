"""mqslam_tpu_torch.core against mqslam_tpu.core on the CPU: the same NumPy
inputs through both packages.  atol 1e-5 throughout: identical float32
formulas, differing only in the order a backend sums three or four terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.core import camera as jcam, quat as jquat, se3 as jse3, \
    smallmat as jsm, so3 as jso3
from mqslam_tpu_torch.core import camera as tcam, quat as tquat, \
    se3 as tse3, smallmat as tsm, so3 as tso3

ATOL = 1e-5


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


@pytest.fixture
def rng():
    return np.random.RandomState(20260101)


def test_smallmat(rng):
    A = rng.randn(5, 4, 3).astype(np.float32)
    B = rng.randn(5, 3, 6).astype(np.float32)
    v = rng.randn(5, 3).astype(np.float32)
    b = rng.randn(5, 4).astype(np.float32)
    tA, tB, tv, tb = map(torch.tensor, (A, B, v, b))
    close(tsm.matmul_small(tA, tB), jsm.matmul_small(A, B))
    close(tsm.matvec_small(tA, tv), jsm.matvec_small(A, v))
    close(tsm.gram(tA), jsm.gram(A))
    close(tsm.gram_rhs(tA, tb), jsm.gram_rhs(A, b))
    # exact float32: the same as a float64 product rounded once, to 1e-6
    np.testing.assert_allclose(tsm.matmul_small(tA, tB).numpy(),
                               A.astype(np.float64) @ B, atol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.5, 3.0])
def test_so3_exp_log(rng, scale):
    r = (rng.randn(32, 3) * scale).astype(np.float32)
    close(tso3.exp(torch.tensor(r)), jso3.exp(jnp.asarray(r)))
    R = np.asarray(jso3.exp(jnp.asarray(r)))
    close(tso3.log(torch.tensor(R)), jso3.log(jnp.asarray(R)))
    close(tso3.hat(torch.tensor(r)), jso3.hat(jnp.asarray(r)))


def test_so3_log_near_pi(rng):
    axis = rng.randn(16, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    r = (axis * (np.pi - 1e-3)).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray(r)))
    # near pi the axis is recovered from small off-diagonal differences:
    # 1e-4 covers the conditioning there
    close(tso3.log(torch.tensor(R)), jso3.log(jnp.asarray(R)), atol=1e-4)


def test_quat(rng):
    """What so3 / se3 use of the quaternion module."""
    q1 = rng.randn(20, 4).astype(np.float32)
    r = rng.randn(20, 3).astype(np.float32)
    close(tquat.normalize(torch.tensor(q1)), jquat.normalize(jnp.asarray(q1)))
    close(tquat.normalize(torch.zeros(4)), jquat.normalize(jnp.zeros(4)))
    close(tquat.identity(), jquat.identity())
    qn = np.asarray(jquat.from_rvec(jnp.asarray(r)))
    close(tquat.to_rvec(torch.tensor(qn)), jquat.to_rvec(jnp.asarray(qn)))
    close(tquat.to_rvec(torch.tensor(-qn)), jquat.to_rvec(jnp.asarray(-qn)))
    R = np.asarray(jquat.to_matrix(jnp.asarray(qn)))
    close(tquat.from_matrix(torch.tensor(R)),
          jquat.from_matrix(jnp.asarray(R)))
    # every Shepperd branch: rotations by ~pi about each axis
    for axis in np.eye(3):
        Rp = np.asarray(jso3.exp(jnp.asarray(axis * 3.1, jnp.float32)))
        close(tquat.from_matrix(torch.tensor(Rp)),
              jquat.from_matrix(jnp.asarray(Rp)))


def test_se3(rng):
    r = (rng.randn(12, 3) * 0.7).astype(np.float32)
    t = rng.randn(12, 3).astype(np.float32)
    pts = rng.randn(12, 3).astype(np.float32)
    jP = jse3.from_rvec_tvec(jnp.asarray(r), jnp.asarray(t))
    tP = tse3.from_rvec_tvec(torch.tensor(r), torch.tensor(t))
    close(tP, jP)
    close(tse3.inv(tP), jse3.inv(jP))
    close(tse3.compose(tP, tse3.inv(tP)), jse3.compose(jP, jse3.inv(jP)))
    close(tse3.apply(tP, torch.tensor(pts)), jse3.apply(jP, jnp.asarray(pts)))
    rv_t, tv_t = tse3.to_rvec_tvec(tP)
    rv_j, tv_j = jse3.to_rvec_tvec(jP)
    close(rv_t, rv_j)
    close(tv_t, tv_j)
    # broadcast R [3,3] against t [12,3]
    close(tse3.from_R_t(torch.eye(3), torch.tensor(t)),
          jse3.from_R_t(jnp.eye(3), jnp.asarray(t)))


CALS = {
    "pinhole": [500.0, 500.0, 0.0, 320.0, 240.0, 0, 0, 0, 0],
    "distorted": [481.2, 480.0, 0.4, 319.5, 239.5, 0.12, -0.05, 1e-3, -2e-3],
    "negative_fy": [481.2, -480.0, 0.0, 319.5, 239.5, 0.05, -0.01, 5e-4,
                    3e-4],
}


@pytest.mark.parametrize("name", sorted(CALS))
def test_camera(rng, name):
    c9 = np.asarray(CALS[name], np.float32)
    jcal = jcam.Cal3DS2.from_array(jnp.asarray(c9))
    tcal = tcam.Cal3DS2.from_array(torch.tensor(c9))
    close(tcal.as_array(), jcal.as_array())
    uv = (rng.rand(64, 2) * [640, 480]).astype(np.float32)
    xn = ((rng.rand(64, 2) - 0.5) * 1.2).astype(np.float32)
    tuv, txn = torch.tensor(uv), torch.tensor(xn)
    close(tcam.normalize_points(tuv, tcal), jcam.normalize_points(uv, jcal))
    # pixels: values ~600, float32 spacing 6e-5 -> atol 2e-4
    close(tcam.denormalize_points(txn, tcal),
          jcam.denormalize_points(xn, jcal), atol=2e-4)
    close(tcam.distort_normalized(txn, tcal),
          jcam.distort_normalized(xn, jcal))
    close(tcam.undistort_normalized(txn, tcal),
          jcam.undistort_normalized(jnp.asarray(xn), jcal))
    close(tcam.undistort_points(tuv, tcal),
          jcam.undistort_points(jnp.asarray(uv), jcal))
    # round trip through the port alone
    back = tcam.distort_normalized(tcam.undistort_normalized(txn, tcal), tcal)
    np.testing.assert_allclose(back.numpy(), xn, atol=1e-5)

    X = (rng.randn(64, 3) + [0, 0, 6]).astype(np.float32)
    r = (rng.randn(3) * 0.2).astype(np.float32)
    t = (rng.randn(3) * 0.3).astype(np.float32)
    jP = jse3.from_rvec_tvec(jnp.asarray(r), jnp.asarray(t))
    tP = tse3.from_rvec_tvec(torch.tensor(r), torch.tensor(t))
    juv, jz = jcam.project(jnp.asarray(X), jP, jcal)
    tuv2, tz = tcam.project(torch.tensor(X), tP, tcal)
    close(tuv2, juv, atol=2e-4)
    close(tz, jz)
    close(tcam.projection_depth(torch.tensor(X), tP),
          jcam.projection_depth(jnp.asarray(X), jP))
    jn, _ = jcam.project_normalized(jnp.asarray(X), jP)
    tn, _ = tcam.project_normalized(torch.tensor(X), tP)
    close(tn, jn)


def test_camera_batched_poses(rng):
    """The port writes vmap out: P [A, 4, 4] against points [A, K, 3] with
    an inserted point axis equals the per-agent calls."""
    c9 = np.asarray(CALS["distorted"], np.float32)
    tcal = tcam.Cal3DS2.from_array(torch.tensor(c9))
    X = torch.tensor((rng.randn(3, 10, 3) + [0, 0, 5]).astype(np.float32))
    r = torch.tensor((rng.randn(3, 3) * 0.2).astype(np.float32))
    t = torch.tensor((rng.randn(3, 3) * 0.2).astype(np.float32))
    P = tse3.from_rvec_tvec(r, t)
    uv, z = tcam.project(X, P[:, None], tcal)
    for a in range(3):
        uv_a, z_a = tcam.project(X[a], P[a], tcal)
        np.testing.assert_allclose(uv[a].numpy(), uv_a.numpy(), atol=1e-6)
        np.testing.assert_allclose(z[a].numpy(), z_a.numpy(), atol=1e-6)


def test_camera_K_and_calibration_round_trip(rng):
    """cal_from_K_dist / K_from_cal: pure re-arrangement, exact; batched; a
    fifth distortion coefficient (k3) is dropped; no ``dist`` means zeros."""
    K = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    K[:, 0, 0], K[:, 1, 1] = 300 + rng.rand(4), -(300 + rng.rand(4))
    K[:, 0, 1] = rng.randn(4) * 0.1
    K[:, :2, 2] = 100 + rng.rand(4, 2)
    dist = (rng.randn(4, 5) * 0.01).astype(np.float32)
    jcal = jcam.cal_from_K_dist(jnp.asarray(K), jnp.asarray(dist))
    tcal = tcam.cal_from_K_dist(torch.tensor(K), torch.tensor(dist))
    np.testing.assert_array_equal(tcal.as_array().numpy(),
                                  np.asarray(jcal.as_array()))
    np.testing.assert_array_equal(tcam.K_from_cal(tcal).numpy(), K)
    np.testing.assert_array_equal(tcam.K_from_cal(tcal).numpy(),
                                  np.asarray(jcam.K_from_cal(jcal)))
    one = tcam.cal_from_K_dist(torch.tensor(K[0]))
    np.testing.assert_array_equal(
        one.as_array().numpy(),
        np.asarray(jcam.cal_from_K_dist(jnp.asarray(K[0])).as_array()))
    assert (one.as_array()[5:] == 0).all()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rvecs(rng, n=24):
    """Rotation vectors of every size, two exact zeros among them."""
    r = rng.randn(n, 3) * np.repeat([0.0, 1e-7, 1e-3, 0.5, 2.0, 3.0],
                                    n // 6)[:, None]
    return r.astype(np.float32)


def test_quat_helpers(rng):
    """delta, from_rvec, axis_angle_from_rvec, to_matrix: 1e-6, zero
    rotations included (axis (0, 0, 1), angle 0, the identity)."""
    r1, r2 = rvecs(rng), rvecs(rng)[::-1].copy()
    jq1, jq2 = jquat.from_rvec(jnp.asarray(r1)), jquat.from_rvec(
        jnp.asarray(r2))
    tq1, tq2 = tquat.from_rvec(torch.tensor(r1)), tquat.from_rvec(
        torch.tensor(r2))
    close(tq1, jq1, atol=1e-6)
    close(tq2, jq2, atol=1e-6)
    np.testing.assert_array_equal(tq1[:4].numpy(), [[0, 0, 0, 1]] * 4)
    close(tquat.delta(tq1, tq2), jquat.delta(jq1, jq2), atol=1e-6)
    close(tquat.to_matrix(tq1), jquat.to_matrix(jq1), atol=1e-6)
    ta, tang = tquat.axis_angle_from_rvec(torch.tensor(r1))
    ja, jang = jquat.axis_angle_from_rvec(jnp.asarray(r1))
    close(ta, ja, atol=1e-6)
    close(tang, jang, atol=1e-6)
    np.testing.assert_array_equal(ta[:4].numpy(), [[0, 0, 1]] * 4)
    np.testing.assert_array_equal(tang[:4].numpy(), 0)


def test_from_rvec_gradient_finite_at_zero():
    """The untaken side of the zero-angle branch divides by a clamped
    angle, so the gradient at the zero rotation is finite (and 0.5 I in
    the vector part, as sin(a/2)/a -> 1/2)."""
    r = torch.zeros(3, requires_grad=True)
    q = tquat.from_rvec(r)
    (g,) = torch.autograd.grad(q[:3].sum(), r)
    np.testing.assert_array_equal(g.numpy(), [0.5, 0.5, 0.5])
    r = torch.zeros(3, requires_grad=True)
    axis, angle = tquat.axis_angle_from_rvec(r)
    (g,) = torch.autograd.grad(axis.sum() + angle, r)
    assert torch.isfinite(g).all()


def test_so3_delta_rvec(rng):
    r1, r2 = rvecs(rng), rvecs(rng)[::-1].copy()
    close(tso3.delta_rvec(torch.tensor(r1), torch.tensor(r2)),
          jso3.delta_rvec(jnp.asarray(r1), jnp.asarray(r2)), atol=1e-6)
    np.testing.assert_array_equal(
        tso3.delta_rvec(torch.tensor(r1), torch.tensor(r1))[:4].numpy(), 0)
    assert tso3.matrix_from_rvec is tso3.exp
    assert tso3.rvec_from_matrix is tso3.log


def test_se3_helpers(rng):
    """identity, delta, from_pose_tum, to_pose_tum: 1e-6 (TUM centres
    ~1, so 1e-6 absolute is float32's own spacing there)."""
    np.testing.assert_array_equal(tse3.identity().numpy(),
                                  np.asarray(jse3.identity()))
    assert tse3.identity(torch.float64, "cpu").dtype == torch.float64
    r = rvecs(rng, 12)
    t = (rng.randn(12, 3) * 0.5).astype(np.float32)
    jP = jse3.from_rvec_tvec(jnp.asarray(r), jnp.asarray(t))
    tP = tse3.from_rvec_tvec(torch.tensor(r), torch.tensor(t))
    close(tse3.delta(tP, tP.flip(0)), jse3.delta(jP, jP[::-1]), atol=1e-6)
    jq, jc = jse3.to_pose_tum(jP)
    tq, tc_ = tse3.to_pose_tum(tP)
    close(tq, jq, atol=1e-6)
    close(tc_, jc, atol=1e-6)
    q = rng.randn(12, 4).astype(np.float32)        # not unit: normalized
    c = rng.randn(12, 3).astype(np.float32)
    close(tse3.from_pose_tum(torch.tensor(q), torch.tensor(c)),
          jse3.from_pose_tum(jnp.asarray(q), jnp.asarray(c)), atol=1e-6)
    # zero rotation: the identity quaternion and the centre -t
    tq0, tc0 = tse3.to_pose_tum(tP[:2])
    np.testing.assert_array_equal(tq0.numpy(), [[0, 0, 0, 1]] * 2)
    np.testing.assert_array_equal(tc0.numpy(), -t[:2])
