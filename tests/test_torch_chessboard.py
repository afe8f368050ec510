"""The chessboard detector of both packages on the same images, on the CPU:
``features._shift``, ``chess_response``, ``detect_corner_candidates``,
``corner_subpix``, ``order_chessboard_corners`` and
``find_chessboard_corners``, on the OpenCV-warped views of
``tests/test_chessboard.py`` and on boards rendered in NumPy
(``frontend/synthetic``).

Tolerances: the response map 1e-5 of its largest magnitude (the JAX package
is jitted, and XLA fuses the ring sums: up to 0.6 at 1.2e6 from its own
unfused result); the candidates' pixels, validity and order equal, -inf pad
entries included, their responses 1e-5 relative; subpixel corners 1e-4 px
with ``ok`` equal; the grid ordering equal; whole detections: ``ok`` equal
and corners 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops import chessboard as jcb, features as jfeat
from mqslam_tpu_torch.frontend import synthetic as syn
from mqslam_tpu_torch.ops import chessboard as tcb, features as tfeat
from test_chessboard import render_board, warp_view

BOARD = (7, 6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotated_view():
    """The ~90-degree rotated 7x5 board of tests/test_chessboard.py."""
    import cv2
    board, _ = render_board(7, 5)
    M = cv2.getRotationMatrix2D((board.shape[1] / 2, board.shape[0] / 2),
                                84, 0.8)
    M[:, 2] += [100, 40]
    img = cv2.warpAffine(board, M, (640, 480), borderValue=128)
    return cv2.GaussianBlur(img, (3, 3), 0.8).astype(np.float32), (7, 5)


def _rendered_view():
    """An 8x6 board rendered in NumPy through a tilted camera, 640x480."""
    tex, _, _, centre = syn.chessboard_scene()
    P = syn.board_view_poses(np.random.RandomState(2), 1, centre, 5.0)
    img = syn.render_plane_sequence(P, tex, size=(640, 480), f=500.0,
                                    plane_z=4.0, tex_scale=64.0)[0]
    return img.astype(np.float32), (8, 6)


@pytest.fixture(scope="module")
def views():
    out = {}
    for i, quad in enumerate([
            [[120, 80], [520, 110], [500, 400], [100, 380]],
            [[80, 120], [560, 60], [580, 420], [60, 360]]]):
        board, _ = render_board(*BOARD)
        img, _ = warp_view(board, quad)
        out[f"warped{i}"] = (img.astype(np.float32), BOARD)
    out["rotated"] = _rotated_view()
    out["rendered"] = _rendered_view()
    noise = np.random.RandomState(0).uniform(0, 255, (480, 640))
    out["no_board"] = (noise.astype(np.float32), BOARD)
    return out


VIEWS = ["warped0", "warped1", "rotated", "rendered", "no_board"]


@pytest.mark.parametrize("dy, dx", [(0, 0), (3, -2), (-5, 4), (0, 7),
                                    (-9, 0), (40, -50)])
def test_shift_matches_the_jax_package(dy, dx):
    img = np.random.RandomState(1).rand(24, 30).astype(np.float32)
    want = np.asarray(jfeat._shift(jnp.asarray(img), dy, dx))
    got = tfeat._shift(torch.tensor(img), dy, dx)
    np.testing.assert_array_equal(got.numpy(), want)
    # leading batch dims shift each image alike
    both = tfeat._shift(torch.tensor(np.stack([img, 2 * img])), dy, dx)
    np.testing.assert_array_equal(both[1].numpy(), 2 * want)


@pytest.mark.parametrize("name", VIEWS)
def test_chess_response(views, name):
    img, _ = views[name]
    want = np.asarray(jcb.chess_response(jnp.asarray(img)))
    got = tcb.chess_response(torch.tensor(img)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name, nms, max_corners", [
    ("warped0", 5, 64), ("rotated", 5, 64), ("rendered", 5, 80),
    ("no_board", 5, 128), ("warped1", 4, 96), ("rendered", 3, 72)])
def test_detect_corner_candidates(views, name, nms, max_corners):
    img, _ = views[name]
    uj, sj, vj = (np.asarray(x) for x in jcb.detect_corner_candidates(
        jnp.asarray(img), max_corners=max_corners, nms=nms))
    ut, st, vt = (x.numpy() for x in tcb.detect_corner_candidates(
        torch.tensor(img), max_corners=max_corners, nms=nms))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ut, uj)       # the -inf pad too, in order
    np.testing.assert_array_equal(st[~vj], sj[~vj])
    np.testing.assert_allclose(st[vj], sj[vj], rtol=1e-5)
    if name != "no_board":
        assert 0 < vj.sum() < max_corners      # both kinds of entry held


@pytest.fixture(scope="module")
def saddles():
    """Three product-of-tanh saddles at known subpixel positions, and
    starts on a random texture (some converge in a few iterations, some
    still move at the 30th), on a flat patch and at the image border."""
    gt = np.array([[100.3, 80.7], [200.6, 120.2], [321.9, 240.4]])
    ys, xs = np.mgrid[0:480, 0:640].astype(np.float64)
    img = np.full((480, 640), 128.0, np.float32)
    for (cx, cy) in gt:
        img += 120 * (np.tanh((xs - cx) / 2)
                      * np.tanh((ys - cy) / 2)).astype(np.float32)
    img[300:, :] = 128.0
    tex = syn.make_texture(np.random.RandomState(5), size=256,
                           blur_passes=1)
    img[320:320 + 150, 400:400 + 230] = tex[:150, :230]
    rng = np.random.RandomState(1)
    start = np.concatenate([
        gt + np.array([[1.2, -0.8], [-1.5, 0.9], [0.7, 1.3]]),
        rng.uniform([410, 330], [620, 460], (24, 2)),
        [[150.3, 380.6], [2.0, 3.0], [637.5, 470.0]]]).astype(np.float32)
    return img, start, gt


def test_corner_subpix(saddles):
    img, start, gt = saddles
    valid = np.ones(len(start), bool)
    valid[-2] = False
    rj, okj = jcb.corner_subpix(jnp.asarray(img), jnp.asarray(start),
                                jnp.asarray(valid))
    rt, okt = tcb.corner_subpix(torch.tensor(img), torch.tensor(start),
                                torch.tensor(valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-4)
    assert np.abs(rt.numpy()[:3] - gt).max() < 0.05
    # the fixed 30 iterations cover both kinds of corner: some have
    # stopped by the 5th, some still move at the 30th
    r5, _ = tcb.corner_subpix(torch.tensor(img), torch.tensor(start),
                              torch.tensor(valid), iters=5)
    r29, _ = tcb.corner_subpix(torch.tensor(img), torch.tensor(start),
                               torch.tensor(valid), iters=29)
    stopped = np.all(r5.numpy() == rt.numpy(), axis=1)
    moving = np.any(r29.numpy() != rt.numpy(), axis=1)
    assert stopped[3:27].sum() >= 3 and moving.sum() >= 3


@pytest.mark.parametrize("name", VIEWS)
def test_order_chessboard_corners(views, name):
    img, board = views[name]
    uv, _, valid = jcb.detect_corner_candidates(
        jnp.asarray(img), max_corners=board[0] * board[1] + 21)
    cand = np.asarray(uv)[np.asarray(valid)]
    okj, cj = jcb.order_chessboard_corners(cand, board)
    okt, ct = tcb.order_chessboard_corners(cand, board)
    assert okt == okj
    np.testing.assert_array_equal(ct, cj)
    assert okj == (name != "no_board")
    # too few candidates: refused alike
    assert tcb.order_chessboard_corners(cand[:5], board)[0] is False


@pytest.mark.parametrize("name", VIEWS)
def test_find_chessboard_corners(views, name):
    img, board = views[name]
    okj, cj = jcb.find_chessboard_corners(img, board)
    okt, ct = tcb.find_chessboard_corners(img, board, device="cpu")
    assert okt == okj == (name != "no_board")
    assert ct.dtype == np.float32 and ct.shape == (board[0] * board[1], 2)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-3)
    # a tensor image is the same call
    okx, cx = tcb.extract_chessboard_features(torch.tensor(img), board,
                                              device="cpu")
    assert okx == okt
    np.testing.assert_array_equal(cx, ct)


def test_find_chessboard_corners_needs_a_cuda_device_by_default(
        views, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcb.find_chessboard_corners(views["warped0"][0], BOARD)
