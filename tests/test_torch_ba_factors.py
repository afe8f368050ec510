"""mqslam_tpu_torch.ba.factors against mqslam_tpu.ba.factors on the CPU:
residuals and Jacobians of the three factors on the same random valid
inputs (poses, points in front of the camera, a distorting Cal3DS2, mixed
sigmas).  The JAX Jacobians are ``vmap(jacfwd(...))``; the port's
projection Jacobian is closed-form and its odometry / prior ones are
``torch.func`` forward mode.  Tolerance 1e-5 relative to the largest
entry: float32 throughout, the closed form summing its chain rule in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from mqslam_tpu.ba import factors as jf
from mqslam_tpu_torch.ba import factors as tf

RTOL = 1e-5
N = 96


def close(t, j, rtol=RTOL):
    j = np.asarray(j)
    t = t.numpy()
    assert t.dtype == np.float32 and t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-12)
    assert float(np.abs(t - j).max()) <= rtol * scale


@pytest.fixture
def rng():
    return np.random.RandomState(20261017)


def obs_inputs(rng, cal9, depth=(2.0, 6.0)):
    p6 = np.concatenate([rng.normal(0, 0.6, (N, 3)),
                         rng.normal(0, 2.0, (N, 3))], 1).astype(np.float32)
    R = Rotation.from_rotvec(p6[:, :3].astype(np.float64)).as_matrix()
    Xc = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                   rng.uniform(*depth, N)], 1)
    pts = (np.einsum("nij,nj->ni", R, Xc) + p6[:, 3:]).astype(np.float32)
    uv = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    cal = np.tile(np.asarray(cal9, np.float32), (N, 1))
    inv_sig = rng.uniform(0.5, 2.0, (N, 1)).astype(np.float32)
    return p6, pts, uv, cal, inv_sig


CALS = {
    "pinhole": [500.0, 500.0, 0.0, 320.0, 240.0, 0, 0, 0, 0],
    "distorted": [520.0, 515.0, 0.7, 318.0, 243.0, 0.08, -0.03, 0.002,
                  -0.001],
    "mirrored": [480.0, -480.0, 0.0, 320.0, 240.0, -0.05, 0.01, 0.0, 0.0],
}


@pytest.mark.parametrize("cal", sorted(CALS))
def test_obs_residual_and_jacobian(rng, cal):
    args = obs_inputs(rng, CALS[cal])
    close(tf.obs_residual(*map(torch.tensor, args)),
          jf.obs_residual(*map(jnp.asarray, args)))
    Jt = tf.obs_residual_jac(*map(torch.tensor, args))
    Jj = jf.obs_residual_jac(*map(jnp.asarray, args))
    assert Jt[0].shape == (N, 2, 6) and Jt[1].shape == (N, 2, 3)
    for t, j in zip(Jt, Jj):
        close(t, j)


def test_obs_jacobian_behind_the_guard(rng):
    """Points at |z| <= 1e-9 in the camera frame take the guarded depth,
    which has no derivative: both packages drop the z column's term."""
    p6, pts, uv, cal, inv_sig = obs_inputs(rng, CALS["pinhole"])
    p6[:, :3] = 0.0                       # identity rotation: Xc = X - c
    pts[:8] = p6[:8, 3:] + np.array([0.3, -0.2, 0.0], np.float32)
    args = (p6, pts, uv, cal, inv_sig)
    for t, j in zip(tf.obs_residual_jac(*map(torch.tensor, args)),
                    jf.obs_residual_jac(*map(jnp.asarray, args))):
        close(t[8:], np.asarray(j)[8:])
        assert torch.isfinite(t).all()


def odo_inputs(rng):
    f = np.concatenate([rng.normal(0, 0.8, (N, 3)),
                        rng.normal(0, 2.0, (N, 3))], 1).astype(np.float32)
    t = np.roll(f, 1, 0) + rng.normal(0, 0.1, f.shape).astype(np.float32)
    mr = rng.normal(0, 0.4, (N, 3)).astype(np.float32)
    mt = rng.normal(0, 1.0, (N, 3)).astype(np.float32)
    inv6 = rng.uniform(0.5, 20.0, (N, 6)).astype(np.float32)
    return f, t, mr, mt, inv6


def test_odo_residual_and_jacobians(rng):
    args = odo_inputs(rng)
    close(tf.odo_residual(*map(torch.tensor, args)),
          jf.odo_residual(*map(jnp.asarray, args)))
    Jt = tf.odo_residual_jac(*map(torch.tensor, args))
    Jj = jf.odo_residual_jac(*map(jnp.asarray, args))
    for t, j in zip(Jt, Jj):
        assert t.shape == (N, 6, 6)
        close(t, j)


def test_prior_residual_and_jacobian(rng):
    f, _, mr, mt, inv6 = odo_inputs(rng)
    args = (f, mr, mt, inv6)
    close(tf.prior_pose_residual(*map(torch.tensor, args)),
          jf.prior_pose_residual(*map(jnp.asarray, args)))
    close(tf.prior_pose_residual_jac(*map(torch.tensor, args)),
          jf.prior_pose_residual_jac(*map(jnp.asarray, args)))


def test_padding_rows_are_finite():
    """The padded odometry / prior slots (zero poses, zero measurements,
    zero weights) give finite zeros, as the solver needs."""
    z6 = np.zeros((4, 6), np.float32)
    z3 = np.zeros((4, 3), np.float32)
    r = tf.odo_residual(*map(torch.tensor, (z6, z6, z3, z3, z6)))
    Jf, Jt = tf.odo_residual_jac(*map(torch.tensor, (z6, z6, z3, z3, z6)))
    Jp = tf.prior_pose_residual_jac(*map(torch.tensor, (z6, z3, z3, z6)))
    for x in (r, Jf, Jt, Jp):
        assert torch.isfinite(x).all() and float(x.abs().max()) == 0.0


def test_retract_single(rng):
    p6 = rng.normal(0, 0.7, (N, 6)).astype(np.float32)
    d6 = rng.normal(0, 0.05, (N, 6)).astype(np.float32)
    import jax
    Rj, cj = jax.vmap(jf.retract_single)(jnp.asarray(p6), jnp.asarray(d6))
    Rt, ct = tf.retract_single(torch.tensor(p6), torch.tensor(d6))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)


@pytest.mark.parametrize("angle", [0.0, 1e-4, 0.3, 0.49, 0.51, 1.5, 2.8])
def test_odo_and_prior_jacobians_across_the_series_switch(rng, angle):
    """The closed form's inverse SO(3) Jacobian switches from its series to
    the trigonometric form at 0.5 rad: the rotation discrepancy placed at
    and around it (and at 0 and near pi) agrees with ``jacfwd``."""
    f, _, _, mt, inv6 = odo_inputs(rng)
    axis = rng.normal(size=(N, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    Rf = Rotation.from_rotvec(f[:, :3].astype(np.float64))
    # to = from composed with the measured rotation and a discrepancy of
    # exactly ``angle`` about a random axis
    mr = rng.normal(0, 0.4, (N, 3))
    Rt = Rf * Rotation.from_rotvec(mr) * Rotation.from_rotvec(axis * angle)
    t = f.copy()
    t[:, :3] = Rt.as_rotvec()
    args = (f, t, mr.astype(np.float32), mt, inv6)
    for a, b in zip(tf.odo_residual_jac(*map(torch.tensor, args)),
                    jf.odo_residual_jac(*map(jnp.asarray, args))):
        close(a, b)
    pr = (Rf * Rotation.from_rotvec(axis * angle)).inv().as_rotvec()
    pargs = (f, pr.astype(np.float32) * -1.0, mt, inv6)
    close(tf.prior_pose_residual_jac(*map(torch.tensor, pargs)),
          jf.prior_pose_residual_jac(*map(jnp.asarray, pargs)))
