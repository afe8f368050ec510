"""Calibration math of both packages on the same inputs, on the CPU:
Zhang's closed form and its refinement (``calib/zhang``) and the epipolar
toolbox with the JAX package's RANSAC draw passed in (``calib/epipolar``).

Tolerances: the closed-form K and the extrinsics from the same homographies
1e-4 relative; one LM iteration from the same parameters 1e-4 relative;
whole calibrations K 1e-3 relative and rms 1e-3 px (the accept decisions of
later iterations may flip at float32's last bits, so only the optimum is
held); F 1e-4 up to sign with inlier masks and counts equal; R and t 1e-4
with chirality counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.calib import epipolar as jep, zhang as jz
from mqslam_tpu.ops import homography as jh
from mqslam_tpu_torch.calib import epipolar as tep, zhang as tz
from mqslam_tpu_torch.frontend import synthetic as syn
from test_calib import render_board_views, two_view_pairs

K_TRUE = np.array([[700.0, 0, 310.0], [0, 695.0, 245.0], [0, 0, 1]])
DIST_TRUE = np.array([0.08, -0.12, 1e-3, -5e-4])
f32 = lambda x: torch.tensor(np.asarray(x, np.float32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boards():
    rng = np.random.RandomState(123456789)
    objp, uvs, _, _ = render_board_views(rng, K_TRUE, DIST_TRUE)
    o = jnp.asarray(objp, jnp.float32)
    u = jnp.asarray(uvs, jnp.float32)
    Hs = jh.fit_homography(
        jnp.broadcast_to(o[None, :, :2], (u.shape[0],) + o.shape[:1] + (2,)),
        u)
    return dict(objp=objp, uvs=uvs, Hs=np.asarray(Hs))


@pytest.fixture(scope="module")
def calibrations(boards):
    j = jz.calibrate_camera(boards["objp"], boards["uvs"], (640, 480))
    t = tz.calibrate_camera(boards["objp"], boards["uvs"], (640, 480),
                            device="cpu")
    return j, t


def test_grid_objp():
    for board, scale in (((2, 3), 1.0), ((8, 6), 0.025)):
        np.testing.assert_array_equal(tz.grid_objp(board, scale),
                                      jz.grid_objp(board, scale))


def test_closed_form_intrinsics_and_extrinsics(boards):
    Hs = boards["Hs"]
    want = [float(x) for x in jax.jit(jz._intrinsics_from_homographies)(
        jnp.asarray(Hs))]
    got = [float(x) for x in tz._intrinsics_from_homographies(f32(Hs))]
    alpha, beta, gamma, u0, v0 = want
    # K's entries 1e-4 relative; the skew, which K leaves out, is roundoff
    # about 0: held to 1e-4 of the focal length
    np.testing.assert_allclose(np.delete(got, 2), np.delete(want, 2),
                               rtol=1e-4)
    assert abs(got[2] - gamma) < 1e-4 * alpha
    K = np.array([[alpha, 0, u0], [0, beta, v0], [0, 0, 1.0]], np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)
    rj, tj = jax.jit(jz._extrinsics_from_H)(jnp.asarray(Hs),
                                            jnp.asarray(K_inv))
    rt, tt = tz._extrinsics_from_H(f32(Hs), f32(K_inv))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-4,
                               atol=1e-6)


def test_one_refinement_iteration(boards, calibrations):
    """One LM iteration from the same (near-optimal, distorted) parameters:
    the residual, its Jacobian and the step."""
    (Kj, dj, rj, tj, _), _ = calibrations
    V = len(rj)
    params = np.concatenate([
        [Kj[0, 0] * 1.01, Kj[1, 1] * 0.99, Kj[0, 2] + 2, Kj[1, 2] - 2],
        0.5 * dj, np.concatenate([rj, tj], axis=1).reshape(-1)])
    objp, uvs = boards["objp"], boards["uvs"]
    want = np.asarray(jz._refine(jnp.asarray(params, jnp.float32),
                                 jnp.asarray(objp, jnp.float32),
                                 jnp.asarray(uvs, jnp.float32), V, iters=1))
    got = tz._refine(f32(params), f32(objp), f32(uvs), V, iters=1)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - params).max() > 1e-3      # it moved
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_calibrate_camera(calibrations):
    (Kj, dj, rj, tj, rmsj), (Kt, dt, rt, tt, rmst) = calibrations
    np.testing.assert_allclose(Kt, Kj, rtol=1e-3)
    assert abs(rmst - rmsj) < 1e-3
    np.testing.assert_allclose(dt, dj, atol=2e-3)
    np.testing.assert_allclose(rt, rj, atol=1e-3)
    np.testing.assert_allclose(tt, tj, atol=1e-3)
    assert rt.shape == tt.shape == (8, 3) and dt.shape == (4,)
    # and both near the truth (the JAX test's bounds)
    np.testing.assert_allclose(Kt[0, 0], K_TRUE[0, 0], rtol=0.02)
    np.testing.assert_allclose(dt[0], DIST_TRUE[0], atol=0.05)


def test_calibrate_camera_from_rendered_images():
    """Six tilted views of an 8x6 board rendered in NumPy at 640x480:
    detector and calibration together recover the renderer's camera, and
    equal the calibration of the JAX detector's corners."""
    board = (8, 6)
    tex, T, sq, centre = syn.chessboard_scene(board)
    Ps = syn.board_view_poses(np.random.RandomState(4), 6, centre, 5.0,
                              jitter=0.3)
    imgs = syn.render_plane_sequence(Ps, tex, size=(640, 480), f=500.0,
                                     plane_z=4.0, tex_scale=64.0)
    K, dist, rv, tv, rms, used = tz.calibrate_camera_from_images(
        imgs, board, square_size=sq, device="cpu")
    assert used.all() and rms < 0.5
    np.testing.assert_allclose(K[0, 0], 500.0, rtol=0.01)
    np.testing.assert_allclose(K[1, 1], 500.0, rtol=0.01)
    np.testing.assert_allclose(K[:2, 2], [320.0, 240.0], atol=5.0)
    # view 0's extrinsics are the board frame's pose in the camera
    P_bc = Ps[0] @ T
    np.testing.assert_allclose(tv[0], P_bc[:3, 3], atol=0.01)
    from mqslam_tpu.ops import chessboard as jcb
    corners = np.stack([jcb.find_chessboard_corners(im, board)[1]
                        for im in imgs])
    K2, *_ = tz.calibrate_camera(tz.grid_objp(board, sq), corners,
                                 (640, 480), device="cpu")
    np.testing.assert_allclose(K, K2, rtol=1e-3)
    with pytest.raises(ValueError, match="3 views"):
        tz.calibrate_camera_from_images(imgs[:2], board, device="cpu")


def test_calibration_needs_a_cuda_device_by_default(boards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tz.calibrate_camera(boards["objp"], boards["uvs"], (640, 480))
    with pytest.raises(RuntimeError, match="CUDA"):
        tz.calibrate_camera_from_images([], (8, 6))


# ----------------------------------------------------------- epipolar --

j8 = jax.jit(jep.fundamental_8point)   # the JAX package's, traced once


def _close_up_to_sign(a, b, tol):
    return min(np.abs(a - b).max(), np.abs(a + b).max()) <= tol


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.RandomState(123456789)
    p1, p2, R, t = two_view_pairs(rng)
    p2_bad = p2.copy()
    p2_bad[:25] += rng.uniform(0.05, 0.2, (25, 2))
    return dict(p1=p1, p2=p2, p2_bad=p2_bad, R=R, t=t)


def test_fundamental_8point(pairs):
    p1, p2 = pairs["p1"], pairs["p2"]
    Fj = np.asarray(j8(jnp.asarray(p1, jnp.float32),
                       jnp.asarray(p2, jnp.float32)))
    Ft = tep.fundamental_8point(f32(p1), f32(p2)).numpy()
    assert _close_up_to_sign(Ft, Fj, 1e-4)
    # with a mask, and batched
    valid = np.arange(len(p1)) % 3 != 0
    Fj = np.asarray(j8(jnp.asarray(p1, jnp.float32),
                       jnp.asarray(p2, jnp.float32), jnp.asarray(valid)))
    Fb = tep.fundamental_8point(f32(np.stack([p1, p1])),
                                f32(np.stack([p2, p2])),
                                torch.tensor(np.stack([valid, valid])))
    assert _close_up_to_sign(Fb[1].numpy(), Fj, 1e-4)


@pytest.mark.parametrize("seed, threshold", [(0, 0.004), (3, 0.002)])
def test_fundamental_ransac_with_the_jax_draw(pairs, seed, threshold):
    p1, p2 = pairs["p1"], pairs["p2_bad"]
    valid = np.ones(len(p1), bool)
    valid[-7:] = False
    key = jax.random.PRNGKey(seed)
    Fj, ij, nj = jep.fundamental_ransac(
        jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32), key,
        valid=jnp.asarray(valid), threshold=threshold)
    draw = np.asarray(jax.random.uniform(key, (256, len(p1))))
    Ft, it, nt = tep.fundamental_ransac(f32(p1), f32(p2),
                                        valid=torch.tensor(valid),
                                        threshold=threshold,
                                        scores=torch.tensor(draw))
    assert _close_up_to_sign(Ft.numpy(), np.asarray(Fj), 1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(nt) == int(nj) > 80
    assert it.numpy()[:25].sum() <= 3 and not it.numpy()[-7:].any()


def test_fundamental_ransac_draws_from_a_generator(pairs):
    p1, p2 = f32(pairs["p1"]), f32(pairs["p2_bad"])
    runs = [tep.fundamental_ransac(
        p1, p2, threshold=0.004,
        generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())
    assert int(runs[0][2]) > 80


def test_decompose_essential_and_relative_pose(pairs):
    p1, p2 = pairs["p1"], pairs["p2"]
    E = np.asarray(j8(jnp.asarray(p1, jnp.float32),
                      jnp.asarray(p2, jnp.float32)))
    for a, b in zip(jax.jit(jep.decompose_essential)(jnp.asarray(E)),
                    tep.decompose_essential(f32(E))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    valid = np.arange(len(p1)) % 4 != 0
    Rj, tj, nj = jax.jit(jep.relative_pose_from_fundamental)(
        jnp.asarray(E), jnp.asarray(p1, jnp.float32),
        jnp.asarray(p2, jnp.float32), jnp.asarray(valid))
    Rt, tt, nt = tep.relative_pose_from_fundamental(
        f32(E), f32(p1), f32(p2), torch.tensor(valid))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert int(nt) == int(nj) >= 0.95 * valid.sum()
    np.testing.assert_allclose(Rt.numpy(), pairs["R"], atol=5e-3)
