"""The port's ``io/`` (its own NumPy copies) against the JAX package's: each
writer on the same data gives the same file byte for byte; each loader on the
same file gives equal arrays."""

import filecmp
import os

import numpy as np
import pytest

from mqslam_tpu.io import (ba_info as jba, images as jimages,
                           intrinsics as jintr, nputil as jnpu, pcd as jpcd,
                           tum as jtum)
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.io import (ba_info as tba, images as timages,
                                 intrinsics as tintr, nputil as tnpu,
                                 pcd as tpcd, tum as ttum)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP = os.path.join(ROOT, "artifacts", "icl_r5b")


def same_file(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


def assert_same_ba(a, b):
    fa, fb = convert.flatten_ba_data(a), convert.flatten_ba_data(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def random_rotations(rng, n):
    q = rng.randn(n, 4)
    return jnpu.quat_to_matrix_np(q / np.linalg.norm(q, axis=1,
                                                     keepdims=True))


def test_nputil(rng):
    q = rng.randn(50, 4)
    for name in ("normalize_quat_np", "quat_to_matrix_np"):
        np.testing.assert_array_equal(getattr(tnpu, name)(q),
                                      getattr(jnpu, name)(q))
    R = random_rotations(rng, 50)
    np.testing.assert_array_equal(tnpu.matrix_to_quat_np(R),
                                  jnpu.matrix_to_quat_np(R))


def test_tum_writer_and_loader(tmp_path, rng):
    n = 20
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = random_rotations(rng, n)
    P[:, :3, 3] = rng.randn(n, 3)
    ts = np.arange(n) / 30.0 + 1 / 30.0
    trajs = [m.trajectory_from_extrinsics(ts, P) for m in (jtum, ttum)]
    for x, y in zip(*trajs):
        np.testing.assert_array_equal(x, y)
    jtum.save_trajectory(tmp_path / "j.txt", trajs[0])
    ttum.save_trajectory(tmp_path / "t.txt", trajs[1])
    same_file(tmp_path / "j.txt", tmp_path / "t.txt")
    for path in (tmp_path / "t.txt",
                 os.path.join(DUMP, "traj_out.cam0-mqslam.txt")):
        a, b = jtum.load_trajectory(path), ttum.load_trajectory(path)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(jtum.extrinsics_from_trajectory(a),
                                      ttum.extrinsics_from_trajectory(b))


@pytest.mark.parametrize("colored", [True, False])
def test_pcd_writer_and_loader(tmp_path, rng, colored):
    pts = rng.randn(40, 3).astype(np.float32)
    colors = rng.randint(0, 256, (40, 3)).astype(np.uint8) if colored \
        else None
    jpcd.save_pcd(tmp_path / "j.pcd", pts, colors)
    tpcd.save_pcd(tmp_path / "t.pcd", pts, colors)
    same_file(tmp_path / "j.pcd", tmp_path / "t.pcd")
    for path in (tmp_path / "t.pcd", os.path.join(DUMP, "map_out-mqslam.pcd")):
        for alpha in (False, True):
            a = jpcd.load_pcd(path, use_alpha=alpha)
            b = tpcd.load_pcd(path, use_alpha=alpha)
            assert len(a) == len(b) and len(a[0]) > 0
            for x, y in zip(a, b):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_array_equal(x, y)


def test_intrinsics_writer_and_loader(tmp_path):
    K = np.array([[481.2, 0, 319.5], [0, -480.0, 239.5], [0, 0, 1]])
    dist = np.array([0.1, -0.02, 0.001, 0.0005, 0.0])
    jintr.save_camera_intrinsics(tmp_path / "j.txt", K, dist, (640, 480))
    tintr.save_camera_intrinsics(tmp_path / "t.txt", K, dist, (640, 480))
    same_file(tmp_path / "j.txt", tmp_path / "t.txt")
    a = jintr.load_camera_intrinsics(tmp_path / "t.txt")
    b = tintr.load_camera_intrinsics(tmp_path / "t.txt")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_allclose(b[0], K)
    bad = tmp_path / "evil.txt"
    bad.write_text("__import__('os').system('true'), 2, 3")
    with pytest.raises(ValueError):
        tintr.load_camera_intrinsics(bad)
    # and the calibration the CLI builds from it
    cal = convert.cal_from_K_dist(b[0], b[1], device="cpu")
    np.testing.assert_allclose(
        cal.as_array().numpy(),
        [481.2, -480.0, 0, 319.5, 239.5, 0.1, -0.02, 0.001, 0.0005],
        rtol=1e-6)


def test_ba_info_loader_on_the_in_repo_dump():
    a = jba.load_ba_data(DUMP, "mqslam", nr_cameras=1, fps=30)
    b = tba.load_ba_data(DUMP, "mqslam", nr_cameras=1, fps=30)
    assert b.nr_steps == a.nr_steps > 10 and len(b.points3D) > 100
    assert_same_ba(a, b)


def test_ba_info_writer(tmp_path):
    data = tba.load_ba_data(DUMP, "mqslam", nr_cameras=1, fps=30)
    jdata = jba.load_ba_data(DUMP, "mqslam", nr_cameras=1, fps=30)
    jba.save_ba_data(str(tmp_path / "j"), "x", jdata)
    tba.save_ba_data(str(tmp_path / "t"), "x", data)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) >= 10
    for n in names:
        same_file(tmp_path / "j" / n, tmp_path / "t" / n)
    assert [vars(f) for f in [tba.make_filenames("d", "n", 2)]] == \
        [vars(f) for f in [jba.make_filenames("d", "n", 2)]]
    # what was written loads back to what was saved
    back = tba.load_ba_data(str(tmp_path / "t"), "x", nr_cameras=1, fps=30)
    fa, fb = convert.flatten_ba_data(data), convert.flatten_ba_data(back)
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k].dtype.kind == "f":
            np.testing.assert_allclose(fa[k], fb[k], atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_noise_model_codec():
    for make in (lambda m: m.NoiseModel.unit(3),
                 lambda m: m.NoiseModel.isotropic(2, 1.5),
                 lambda m: m.NoiseModel.diagonal([0.05] * 3 + [0.2] * 3)):
        a, b = make(jba), make(tba)
        assert a.encode() == b.encode()
        back = tba.NoiseModel.decode(b.encode().split(), b.dim)
        assert back.kind == b.kind
        np.testing.assert_array_equal(back.sigmas, b.sigmas)
    with pytest.raises(ValueError):
        tba.NoiseModel.decode(["Gaussian", "1"], 1)


def test_image_paths_and_loading(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    for name in ("img-10.png", "img-2.png", "img-1.png", "notes.txt"):
        if name.endswith(".png"):
            Image.fromarray(rng.randint(0, 256, (12, 16)).astype(np.uint8)
                            ).save(tmp_path / name)
        else:
            (tmp_path / name).write_text("x")
    a = jimages.image_filepaths_by_directory(str(tmp_path))
    b = timages.image_filepaths_by_directory(str(tmp_path))
    assert a == b
    assert [os.path.basename(p) for p in b] == ["img-1.png", "img-2.png",
                                                "img-10.png"]
    for p in b:
        np.testing.assert_array_equal(timages.load_image_gray(p),
                                      jimages.load_image_gray(p))
    frames = list(timages.iter_images_gray(str(tmp_path)))
    assert len(frames) == 3 and frames[0].dtype == np.float32 \
        and frames[0].shape == (12, 16)
