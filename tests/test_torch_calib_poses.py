"""Multi-camera relative poses (``calib/relative``) and the realtime-pose
step (``calib/realtime``) of both packages on the same inputs, on the CPU,
and the ``calibrate`` subcommands that wrap them (``pose``, ``relative``,
``two-view``) against the JAX package's on the same files.

Tolerances: relative poses and the worst reprojection error 1e-4; realtime
poses 1e-4 and the axis overlay equal; snapshot files byte-equal given the
same pose, and 1e-4 from the command line; printed text equal with its
numbers 1e-4 apart (plus the printed rounding), but for ``two-view``, whose
numbers on a planar board are roundoff's choice (see its test).
"""

import os
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.calib import (realtime as jrt, relative as jrel,
                              zhang as jz)
from mqslam_tpu.cli import calibrate as jcli
from mqslam_tpu.core import camera as jcam
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.calib import realtime as trt, relative as trel
from mqslam_tpu_torch.cli import calibrate as tcli
from mqslam_tpu_torch.io import intrinsics as tintr
from test_chessboard import render_board, warp_view
from test_torch_calibrate_cli import render_board_dir


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_calibrate_relative_poses():
    """The two-camera rig of tests/test_calib.py (undistorted: its second
    board lies outside the image, where a distortion model folds over),
    both packages, three images."""
    rng = np.random.RandomState(123456789)
    rig_R = cv2.Rodrigues(np.array([0.0, 0.3, 0.0]))[0]
    P_rig = np.eye(4)
    P_rig[:3, :3] = rig_R
    P_rig[:3, 3] = [0.25, 0.0, 0.05]
    board0 = jz.grid_objp((5, 7), 0.04)
    board1 = board0 + np.array([0.8, 0.0, 0.0])
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    dist = np.zeros(4)
    imgs0, imgs1 = [], []
    for _ in range(3):
        P0 = np.eye(4)
        P0[:3, :3] = cv2.Rodrigues(rng.uniform(-0.1, 0.1, 3))[0]
        P0[:3, 3] = np.array([0.0, 0.0, 0.6]) + rng.uniform(-0.05, 0.05, 3)
        P1 = P_rig @ P0
        for P, board, out in ((P0, board0, imgs0), (P1, board1, imgs1)):
            uv, _ = cv2.projectPoints(board, cv2.Rodrigues(P[:3, :3])[0],
                                      P[:3, 3], K, dist)
            out.append(uv.reshape(-1, 2) + 0.1 * rng.randn(len(board), 2))
    calj = jcam.cal_from_K_dist(jnp.asarray(K, jnp.float32),
                                jnp.asarray(dist, jnp.float32))
    calt = convert.cal_from_K_dist(K, dist, device="cpu")
    relj, worstj = jrel.calibrate_relative_poses(
        [imgs0, imgs1], [board0, board1], [calj, calj])
    relt, worstt = trel.calibrate_relative_poses(
        [imgs0, imgs1], [board0, board1], [calt, calt], device="cpu")
    for a, b in zip(relt, relj):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert abs(worstt - worstj) < 1e-4 and worstt < 1.0
    np.testing.assert_allclose(relt[1][:3, :3], rig_R, atol=5e-3)
    # the SO(3)-projected variant is host NumPy on the same averages
    proj, _ = trel.calibrate_relative_poses(
        [imgs0, imgs1], [board0, board1], [calt, calt], project_to_se3=True,
        device="cpu")
    R = proj[1][:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(R, relt[1][:3, :3], atol=1e-3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            trel.calibrate_relative_poses([imgs0], [board0], [calt])


def test_pose_from_chessboard_frame_and_snapshot(tmp_path):
    board, _ = render_board(7, 6)
    img, _ = warp_view(board, [[120, 80], [520, 110], [500, 400],
                               [100, 380]])
    img = img.astype(np.float32)
    K = np.array([[560.0, 0, 320.0], [0, 540.0, 240.0], [0, 0, 1.0]])
    dist = np.array([0.01, -0.02, 0.0, 0.0])
    okj, rj, tj, oj = jrt.pose_from_chessboard_frame(img, (7, 6), K, dist,
                                                     square_size=1.5)
    okt, rt, tt, ot = trt.pose_from_chessboard_frame(img, (7, 6), K, dist,
                                                     square_size=1.5,
                                                     device="cpu")
    assert okt and okj
    np.testing.assert_allclose(rt, rj, atol=1e-4)
    np.testing.assert_allclose(tt, tj, rtol=1e-4, atol=1e-4)
    assert ot.shape == oj.shape == (480, 640, 3) and ot.dtype == np.uint8
    np.testing.assert_array_equal(ot, oj)
    okn, *rest = trt.pose_from_chessboard_frame(
        np.full((480, 640), 128.0, np.float32), (7, 6), K, device="cpu")
    assert okn is False and rest == [None, None, None]
    # snapshots: the same files, byte for byte, from the same pose
    pj = jrt.save_pose_snapshot(str(tmp_path / "j"), 3, oj, rj, tj)
    pt = trt.save_pose_snapshot(str(tmp_path / "t"), 3, oj, rj, tj)
    for a, b in zip(pj, pt):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            trt.pose_from_chessboard_frame(img, (7, 6), K)


# ------------------------------------------------- the command line --

NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def numbers_and_text(said):
    """(the text with every number replaced by '#' and without white
    space: NumPy pads printed arrays to their widest entry; the
    numbers)."""
    text = re.sub(r"\s+", "", NUM.sub("#", said))
    return text, np.array([float(v) for v in NUM.findall(said)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("poses")
    sq = render_board_dir(str(d / "cam0"), 2, seed=5)
    render_board_dir(str(d / "cam1"), 2, seed=6)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    tintr.save_camera_intrinsics(str(d / "k.txt"), K,
                                 np.array([0.01, -0.01, 0, 0, 0]),
                                 (640, 480))
    return dict(dir=d, sq=sq, intr=str(d / "k.txt"))


def run_both(capsys, argv_of):
    """Run the JAX and the port command lines (``argv_of(name)``); return
    their exit codes and printed text."""
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        extra = [] if name == "jax" else ["--device", "cpu"]
        rc = cli.main(argv_of(name) + extra)
        out[name] = (rc, capsys.readouterr().out)
    return out


def assert_same_report(a, b, atol):
    ta, na = numbers_and_text(a)
    tb, nb = numbers_and_text(b)
    assert ta == tb
    np.testing.assert_allclose(nb, na, rtol=0, atol=atol)


def test_cli_pose(files, capsys):
    d = files["dir"]
    out = run_both(capsys, lambda name: [
        "pose", str(d / "cam0"), "8x6", files["intr"], "-o",
        str(d / f"snap_{name}"), "--square-size", str(files["sq"])])
    (rcj, sj), (rct, st) = out["jax"], out["port"]
    assert rcj == rct == 0 and "pose estimated in 2/2 frames" in st
    assert_same_report(sj, st, atol=2e-4)          # printed to 4 decimals
    names = sorted(os.listdir(d / "snap_port"))
    assert names == sorted(os.listdir(d / "snap_jax")) and len(names) == 4
    for n in names:
        a = d / "snap_jax" / n
        b = d / "snap_port" / n
        if n.endswith(".txt"):
            ta, na = numbers_and_text(a.read_text())
            tb, nb = numbers_and_text(b.read_text())
            assert ta == tb
            np.testing.assert_allclose(nb, na, rtol=1e-4, atol=1e-4)
        else:
            from PIL import Image
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)))


def test_cli_relative(files, capsys):
    d = files["dir"]
    out = run_both(capsys, lambda name: [
        "relative", files["intr"], "8x6", str(d / "cam0"), str(d / "cam1"),
        "--square-size", str(files["sq"])])
    (rcj, sj), (rct, st) = out["jax"], out["port"]
    assert rcj == rct == 0 and "(2 joint images)" in st
    assert_same_report(sj, st, atol=1e-4)


def test_cli_two_view(files, capsys):
    """Both packages print the same report.  Its numbers are not compared:
    the board's corners are coplanar, so the 8-point system has a
    three-dimensional null space and F (hence R, t and the counts) is
    roundoff's choice in either package.  The port's R and t must still be
    a rotation and a unit direction, and its 8-point E (one vector of that
    null space) must hold the corners' epipolar constraint."""
    from mqslam_tpu_torch.calib import epipolar as tep
    from mqslam_tpu_torch.core import camera as tcam
    from mqslam_tpu_torch.ops import chessboard as tcb
    d = files["dir"]
    a, b = (str(d / "cam0" / f"view_0{i}.png") for i in (0, 1))
    out = run_both(capsys, lambda name: [
        "two-view", files["intr"], "8x6", a, b])
    (rcj, sj), (rct, st) = out["jax"], out["port"]
    assert rcj == rct == 0
    tj, nj = numbers_and_text(sj)
    tt, nt = numbers_and_text(st)
    assert tt == tj and nt[13] == nt[15] == nj[13] == 48
    R, t = nt[:9].reshape(3, 3), nt[9:12]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.norm(t) - 1.0) < 1e-5
    K, dist, _ = tintr.load_camera_intrinsics(files["intr"])
    cal = convert.cal_from_K_dist(K, dist, device="cpu")
    from mqslam_tpu_torch.io import images
    xs = []
    for p in (a, b):
        ok, c = tcb.find_chessboard_corners(images.load_image_gray(p),
                                            (8, 6), device="cpu")
        xs.append(tcam.undistort_points(torch.tensor(c), cal))
    E = tep.fundamental_8point(*xs).numpy()
    h = [np.concatenate([x.numpy(), np.ones((len(x), 1))], 1) for x in xs]
    assert np.abs(np.einsum("ni,ij,nj->n", h[1], E, h[0])).max() < 1e-4
    blank = str(d / "blank.png")
    from mqslam_tpu_torch.viz.painter import save_png
    save_png(blank, np.full((480, 640), 128, np.uint8))
    assert tcli.main(["two-view", files["intr"], "8x6", a, blank,
                      "--device", "cpu"]) == 1
    assert "not found" in capsys.readouterr().err
