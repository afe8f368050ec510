"""The port's command line over files, on the CPU: 8-bit PNG frames,
``camera_intrinsics.txt``, ``init_pose.txt`` and ``init_points.pcd`` (or a
chessboard in frame 0) in, a TUM trajectory, a PCD map and a ``BA_info.*``
dump (and debug views) out; the outputs load back through BOTH packages'
``io``.  320x240, 128 tracks, 7 frames."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mqslam_tpu.ba import validate as jvalidate
from mqslam_tpu.io import ba_info as jba, pcd as jpcd, tum as jtum
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.cli import slam_run
from mqslam_tpu_torch.frontend import synthetic as tsyn
from mqslam_tpu_torch.io import (ba_info as tba, intrinsics as tintr,
                                 pcd as tpcd, tum as ttum)
from mqslam_tpu_torch.ops import features as tfeat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, SIZE, PLANE_Z, N_FRAMES = 250.0, (320, 240), 4.0, 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the tier-1 command's parallel workers,
    torch's default threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("seq")
    imgs, P_list, *_ = tsyn.build_sequence(
        n_frames=N_FRAMES, size=SIZE, f=F, plane_z=PLANE_Z, seed=7,
        ang_rate=0.03, vel=(0.35, 0.035, 0.07))
    os.makedirs(d / "frames")
    imgs8 = np.clip(np.rint(imgs), 0, 255).astype(np.uint8)
    for i, im in enumerate(imgs8):
        Image.fromarray(im).save(d / "frames" / f"frame-{i}.png")
    K = np.array([[F, 0, SIZE[0] / 2], [0, F, SIZE[1] / 2], [0, 0, 1]])
    tintr.save_camera_intrinsics(d / "camera_intrinsics.txt", K,
                                 np.zeros(5), SIZE)
    np.savetxt(d / "init_pose.txt", P_list[0])
    uv, valid = tfeat.detect_corners(torch.tensor(imgs8[0].astype(np.float32)),
                                     max_corners=96, cell=12)
    uv = uv[valid][:64].numpy()
    objp = tsyn.backproject_to_plane(uv, P_list[0], F,
                                     (SIZE[0] / 2, SIZE[1] / 2), PLANE_Z)
    # plus points the visibility filter must drop: behind, and off-image
    extra = np.array([[0.0, 0.0, -3.0], [40.0, 0.0, PLANE_Z]])
    tpcd.save_pcd(d / "init_points.pcd", np.concatenate([objp, extra]))
    return dict(dir=d, P_list=P_list, n_init=len(uv))


def run_cli(dataset, out, *extra):
    d = dataset["dir"]
    return slam_run.main([
        str(d / "frames"), str(d / "camera_intrinsics.txt"),
        "--init-pose", str(d / "init_pose.txt"),
        "--init-points", str(d / "init_points.pcd"),
        "--traj-out", str(out / "traj_out.cam0-mqslam.txt"),
        "--map-out", str(out / "map_out-mqslam.pcd"),
        "--ba-info-dir", str(out), "--max-tracks", "128",
        "--target-keypoints", "100", "--device", "cpu", *extra])


def test_cli_outputs_load_through_both_packages(dataset, tmp_path, capsys):
    assert run_cli(dataset, tmp_path) == 0
    said = capsys.readouterr().out
    assert f"init: {dataset['n_init']}/{dataset['n_init'] + 2}" in said
    assert f"done: {N_FRAMES}/{N_FRAMES} frames accepted" in said

    traj = tmp_path / "traj_out.cam0-mqslam.txt"
    a, b = jtum.load_trajectory(traj), ttum.load_trajectory(traj)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(b.timestamps) == N_FRAMES
    np.testing.assert_allclose(b.timestamps[0], 1 / 30.0)
    # the trajectory follows the known camera path (8-bit frames)
    c_gt = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in dataset["P_list"]])
    assert np.abs(b.locations - c_gt).max() < 0.02

    mp = tmp_path / "map_out-mqslam.pcd"
    pj, pt = jpcd.load_pcd(mp), tpcd.load_pcd(mp)
    np.testing.assert_array_equal(pj[0], pt[0])
    np.testing.assert_array_equal(pj[1], pt[1])
    assert len(pt[0]) >= dataset["n_init"]
    np.testing.assert_allclose(pt[0][:, 2][:dataset["n_init"]], PLANE_Z,
                               atol=1e-4)

    dj = jba.load_ba_data(str(tmp_path), "mqslam", nr_cameras=1, fps=30)
    dt = tba.load_ba_data(str(tmp_path), "mqslam", nr_cameras=1, fps=30)
    fj, ft = convert.flatten_ba_data(dj), convert.flatten_ba_data(dt)
    assert fj.keys() == ft.keys()
    for k in fj:
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
    assert dt.nr_steps == N_FRAMES and len(dt.points3D) == len(pt[0])
    assert jvalidate.validate_data_integrity(dt)
    assert sum(len(o) for o in dt.odometry) >= 1      # a keyframe fired


def test_cli_max_frames_and_quiet(dataset, tmp_path, capsys):
    assert run_cli(dataset, tmp_path, "--max-frames", "3", "--quiet") == 0
    said = capsys.readouterr().out
    assert said.startswith("done: 3/3 frames accepted")
    assert len(ttum.load_trajectory(
        tmp_path / "traj_out.cam0-mqslam.txt").timestamps) == 3


@pytest.fixture(scope="module")
def board_dataset(tmp_path_factory):
    """A board sequence: an 8x6 chessboard in the random texture where
    frame 0 sees it whole, 8-bit PNG frames, no init files."""
    from PIL import Image
    d = tmp_path_factory.mktemp("board_seq")
    imgs, P_list, T_board, sq = tsyn.build_chessboard_sequence(
        n_frames=N_FRAMES, size=SIZE, f=F, plane_z=PLANE_Z, seed=7,
        ang_rate=0.03, vel=(0.35, 0.035, 0.07))
    os.makedirs(d / "frames")
    for i, im in enumerate(np.clip(np.rint(imgs), 0, 255).astype(np.uint8)):
        Image.fromarray(im).save(d / "frames" / f"frame-{i}.png")
    K = np.array([[F, 0, SIZE[0] / 2], [0, F, SIZE[1] / 2], [0, 0, 1]])
    tintr.save_camera_intrinsics(d / "camera_intrinsics.txt", K,
                                 np.zeros(5), SIZE)
    # ground-truth camera centres in the board's frame (grid_objp's)
    Tinv = np.linalg.inv(T_board)
    centres = np.stack([Tinv[:3, :3] @ (-(P[:3, :3].T @ P[:3, 3]))
                        + Tinv[:3, 3] for P in P_list])
    return dict(dir=d, sq=sq, centres=centres)


def run_board_cli(ds, out, *extra):
    d = ds["dir"]
    return slam_run.main([
        str(d / "frames"), str(d / "camera_intrinsics.txt"),
        "--init-chessboard", "8x6", "--square-size", repr(ds["sq"]),
        "--traj-out", str(out / "traj.txt"), "--map-out",
        str(out / "map.pcd"), "--ba-info-dir", str(out), "--max-tracks",
        "128", "--target-keypoints", "100", "--device", "cpu", *extra])


def test_cli_init_chessboard(board_dataset, tmp_path, capsys):
    """Frame 0's board corners (the JAX detector's, within 1e-3 px) are the
    bootstrap; the trajectory follows the ground truth in the board's
    frame."""
    from mqslam_tpu.ops import chessboard as jcb
    from mqslam_tpu_torch.io import images
    assert run_board_cli(board_dataset, tmp_path) == 0
    said = capsys.readouterr().out
    assert "init: 48 chessboard corners detected" in said
    assert f"done: {N_FRAMES}/{N_FRAMES} frames accepted" in said
    frame0 = images.load_image_gray(
        board_dataset["dir"] / "frames" / "frame-0.png")
    ok, want = jcb.find_chessboard_corners(frame0, (8, 6))
    assert ok
    dt = tba.load_ba_data(str(tmp_path), "mqslam", nr_cameras=1, fps=30)
    np.testing.assert_allclose(dt.points2D[0][0][:48], want, rtol=0,
                               atol=1e-3)
    traj = ttum.load_trajectory(tmp_path / "traj.txt")
    assert np.abs(traj.locations - board_dataset["centres"]).max() < 0.03
    # the board's corners are the map's first landmarks, on its plane
    pts = tpcd.load_pcd(tmp_path / "map.pcd")[0]
    np.testing.assert_allclose(pts[:48, 2], 0.0, atol=1e-6)


def test_cli_debug_dir(board_dataset, tmp_path, capsys):
    """``--debug-dir`` with ``--debug-every``: PNGs on the frames the JAX
    runner draws (every 4th, keyframes, rejections), and a trajectory
    file byte-equal to the run without views."""
    plain, dbg = tmp_path / "plain", tmp_path / "dbg"
    os.makedirs(plain)
    os.makedirs(dbg)
    assert run_board_cli(board_dataset, plain, "--quiet") == 0
    assert run_board_cli(board_dataset, dbg, "--quiet", "--debug-dir",
                         str(dbg / "views"), "--debug-every", "4") == 0
    for f in ("traj.txt", "map.pcd"):
        assert (dbg / f).read_bytes() == (plain / f).read_bytes()
    dt = tba.load_ba_data(str(dbg), "mqslam", nr_cameras=1, fps=30)
    kf = {f for f in range(N_FRAMES) if dt.odometry[f]}
    stamps = ttum.load_trajectory(dbg / "traj.txt").timestamps
    kept = set(np.rint(stamps * 30.0).astype(int) - 1)
    due = {f for f in range(1, N_FRAMES)
           if f % 4 == 0 or f in kf or f not in kept}
    names = sorted(os.listdir(dbg / "views"))
    assert names == sorted(f"composite{k}d_{f:05d}.png" for f in due
                           for k in (2, 3))
    assert kf - {f for f in due if f % 4 == 0}      # a keyframe drew too


def test_cli_needs_init_and_images(dataset, tmp_path, capsys):
    d = dataset["dir"]
    assert slam_run.main([str(d / "frames"),
                          str(d / "camera_intrinsics.txt"),
                          "--device", "cpu"]) == 1
    assert "--init-pose" in capsys.readouterr().err
    os.makedirs(tmp_path / "empty")
    assert slam_run.main([str(tmp_path / "empty"),
                          str(d / "camera_intrinsics.txt"),
                          "--device", "cpu"]) == 1
    assert "No images" in capsys.readouterr().err


def test_cli_defaults_to_the_cuda_device(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = dataset["dir"]
    with pytest.raises(RuntimeError, match="CUDA"):
        slam_run.main([str(d / "frames"), str(d / "camera_intrinsics.txt"),
                       "--init-pose", str(d / "init_pose.txt"),
                       "--init-points", str(d / "init_points.pcd")])


def test_module_runs_as_a_program():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "mqslam_tpu_torch.cli.slam_run", "--help"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--init-points" in out.stdout
