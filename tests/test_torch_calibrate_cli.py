"""The port's ``calibrate`` command line against the JAX package's on the
same files, on the CPU: ``intrinsics`` over a directory of 8x6 boards
rendered in NumPy (640x480), then ``undistort`` with the file it wrote.
(``pose``, ``relative`` and ``two-view`` are held in
``test_torch_calib_poses.py``, beside the library calls they wrap.)

Tolerances: K 1e-3 relative, the distortion 2e-3, the image size equal;
undistorted PNGs equal but for pixels one gray level apart (rounding ties
of float results that differ by the jitted reference's roundoff, at most
0.1 % of the pixels).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mqslam_tpu.cli import calibrate as jcli
from mqslam_tpu_torch.cli import calibrate as tcli
from mqslam_tpu_torch.frontend import synthetic as syn
from mqslam_tpu_torch.io import images, intrinsics as tintr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOARD = "8x6"
F, SIZE = 500.0, (640, 480)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render_board_dir(d, n, seed):
    """``n`` tilted 640x480 views of an 8x6 board as PNGs in ``d``; returns
    the square size in world units."""
    from mqslam_tpu_torch.viz.painter import save_png
    tex, _, sq, centre = syn.chessboard_scene()
    Ps = syn.board_view_poses(np.random.RandomState(seed), n, centre, 5.0,
                              jitter=0.3)
    imgs = syn.render_plane_sequence(Ps, tex, size=SIZE, f=F, plane_z=4.0,
                                     tex_scale=64.0)
    os.makedirs(d, exist_ok=True)
    for i, im in enumerate(imgs):
        save_png(os.path.join(d, f"view_{i:02d}.png"),
                 np.clip(np.rint(im), 0, 255).astype(np.uint8))
    return sq


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib")
    sq = render_board_dir(str(d / "views"), 4, seed=4)
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        extra = [] if name == "jax" else ["--device", "cpu"]
        f = str(d / f"{name}_intrinsics.txt")
        rc = cli.main(["intrinsics", str(d / "views"), BOARD, "-o", f,
                       "--square-size", str(sq)] + extra)
        out[name] = (rc, f)
    return dict(dir=d, sq=sq, **out)


def test_intrinsics(runs, capsys):
    (rcj, fj), (rct, ft) = runs["jax"], runs["port"]
    assert rcj == rct == 0
    Kj, dj, sj = tintr.load_camera_intrinsics(fj)
    Kt, dt, st = tintr.load_camera_intrinsics(ft)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-3)
    np.testing.assert_allclose(dt, dj, atol=2e-3)
    assert tuple(st) == tuple(sj) == SIZE and len(dt) == 5 and dt[4] == 0
    np.testing.assert_allclose(Kt[0, 0], F, rtol=0.01)
    np.testing.assert_allclose(Kt[:2, 2], [320.0, 240.0], atol=5.0)


def test_intrinsics_says_what_it_did(runs, tmp_path, capsys):
    f = str(tmp_path / "k.txt")
    assert tcli.main(["intrinsics", str(runs["dir"] / "views"), BOARD,
                      "-o", f, "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "used 4/4 images; reprojection RMS" in said
    assert f"wrote {f}" in said
    os.makedirs(tmp_path / "empty")
    assert tcli.main(["intrinsics", str(tmp_path / "empty"), BOARD,
                      "--device", "cpu"]) == 1
    assert "no images" in capsys.readouterr().err


@pytest.mark.parametrize("alpha", ["1.0", "0.0"])
def test_undistort(runs, tmp_path, capsys, alpha):
    intr = runs["port"][1]
    img = os.path.join(runs["dir"], "views", "view_01.png")
    oj, ot = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert jcli.main(["undistort", intr, img, "-o", oj,
                      "--alpha", alpha]) == 0
    said_j = capsys.readouterr().out.replace(oj, "OUT")
    assert tcli.main(["undistort", intr, img, "-o", ot, "--alpha", alpha,
                      "--device", "cpu"]) == 0
    said_t = capsys.readouterr().out.replace(ot, "OUT")
    assert said_t == said_j                       # the same ROI
    a = images.load_image_gray(oj).astype(int)
    b = images.load_image_gray(ot).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3


def test_cli_defaults_to_the_cuda_device(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = os.path.join(runs["dir"], "views", "view_01.png")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["undistort", runs["port"][1], img, "-o", "unused.png"])


def test_module_runs_as_a_program():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "mqslam_tpu_torch.cli.calibrate", "pose",
         "--help"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--square-size" in out.stdout
