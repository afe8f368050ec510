"""Image undistortion of both packages on the same inputs, on the CPU:
``get_optimal_new_camera_matrix`` (alpha 0, 0.5, 1; negative fy),
``_remap`` and ``undistort_image`` (float, uint8, three channels, crop).

Tolerances: K_new 1e-5 relative and the ROI equal; float images 1e-3 gray
levels; uint8 images equal except at rounding ties (the float results lie
within 1e-3 of a half level there, and differ by one level).  The images are
held against the JAX package's functions run op by op (``jax.disable_jit``):
jitted, XLA fuses the dst -> src coordinate map, which moves a source
coordinate by an ulp and the sample by up to 1.6e-3 gray levels on this
image (its own op-by-op result against its jitted one).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.calib import undistort as jud
from mqslam_tpu.core import camera as jcam
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.calib import undistort as tud

K = np.array([[540.0, 0, 320.0], [0, 530.0, 250.0], [0, 0, 1.0]])
DIST = np.array([-0.28, 0.08, 0.001, -0.0005])
SIZE = (640, 480)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cals(fy=530.0):
    Kf = K.copy()
    Kf[1, 1] = fy
    return (jcam.cal_from_K_dist(jnp.asarray(Kf, jnp.float32),
                                 jnp.asarray(DIST, jnp.float32)),
            convert.cal_from_K_dist(Kf, DIST, device="cpu"))


@pytest.fixture(scope="module")
def img():
    rng = np.random.RandomState(0)
    return cv2.GaussianBlur(
        rng.uniform(0, 255, SIZE[::-1]).astype(np.float32), (7, 7), 2)


@pytest.mark.parametrize("alpha, fy", [(0.0, 530.0), (0.5, 530.0),
                                       (1.0, 530.0), (1.0, -530.0),
                                       (0.0, -530.0)])
def test_optimal_new_camera_matrix(alpha, fy):
    calj, calt = cals(fy)
    Kj, roij = jud.get_optimal_new_camera_matrix(calj, SIZE, alpha)
    Kt, roit = tud.get_optimal_new_camera_matrix(calt, SIZE, alpha)
    assert Kt.dtype == np.float64
    np.testing.assert_allclose(Kt, Kj, rtol=1e-5)
    assert roit == roij and all(isinstance(v, int) for v in roit)
    assert np.sign(Kt[1, 1]) == np.sign(fy)
    # a new size scales the matrix alike
    Kj2, roij2 = jud.get_optimal_new_camera_matrix(calj, SIZE, alpha,
                                                   new_size=(320, 240))
    Kt2, roit2 = tud.get_optimal_new_camera_matrix(calt, SIZE, alpha,
                                                   new_size=(320, 240))
    np.testing.assert_allclose(Kt2, Kj2, rtol=1e-5)
    assert roit2 == roij2


def test_remap(img):
    calj, calt = cals()
    Kn, _ = cv2.getOptimalNewCameraMatrix(K, DIST, SIZE, 1)
    with jax.disable_jit():
        want = np.asarray(jud._remap(jnp.asarray(img),
                                     calj.as_array().astype(jnp.float32),
                                     jnp.asarray(Kn, jnp.float32)))
    got = tud._remap(torch.tensor(img), calt.as_array(),
                     torch.tensor(Kn, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("alpha, crop", [(1.0, True), (0.0, True),
                                         (0.5, False)])
def test_undistort_float(img, alpha, crop):
    calj, calt = cals()
    with jax.disable_jit():
        oj, roij = jud.undistort_image(img, calj, alpha=alpha, crop=crop)
    ot, roit = tud.undistort_image(img, calt, alpha=alpha, crop=crop,
                                   device="cpu")
    assert roit == roij and ot.shape == oj.shape and ot.dtype == oj.dtype
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-3)


def test_undistort_uint8_three_channels(img):
    calj, calt = cals()
    rgb = np.stack([img, img * 0.5, img * 0.25], axis=-1)
    rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
    with jax.disable_jit():
        oj, roij = jud.undistort_image(rgb8, calj, alpha=1.0)
        fj, _ = jud.undistort_image(rgb8.astype(np.float32), calj,
                                    alpha=1.0)
    ot, roit = tud.undistort_image(rgb8, calt, alpha=1.0, device="cpu")
    assert ot.dtype == np.uint8 and ot.shape == oj.shape
    assert ot.shape[:2] == (roit[3], roit[2]) and roit == roij
    # where they differ, the float result sits at a rounding tie
    diff = ot.astype(int) - oj.astype(int)
    tie = np.abs(np.abs(fj - np.floor(fj)) - 0.5) < 1e-3
    assert np.abs(diff).max() <= 1
    assert np.all(tie[diff != 0])
    assert (diff != 0).mean() < 1e-3


def test_undistort_needs_a_cuda_device_by_default(img, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tud.undistort_image(img, cals()[1])
