"""The port's ``ba_run`` command line against the JAX package's, on the CPU:
the synthetic cube (``runFromGenerated``) and a one-camera dump written by
the port's writers, through both CLIs in mode 0 (LM, then the float64
polish), and the cube in modes 1 and 2 (the incremental solve); the output
files hold the same trajectory and map.  The synthetic
generator itself is held equal to the JAX package's (NumPy, same seeds).

Tolerances: timestamps and file layout equal; camera centres 1e-4 m,
quaternions 1e-5, landmarks 1e-3 m (both solves stop at the float32 cost
floor, then polish in float64)."""

import os

import numpy as np
import pytest
import torch

from mqslam_tpu.ba import synthetic as jsyn
from mqslam_tpu.cli import ba_run as jcli
from mqslam_tpu.io import pcd as jpcd, tum as jtum
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import synthetic as tsyn
from mqslam_tpu_torch.cli import ba_run as tcli
from mqslam_tpu_torch.io import ba_info as tio, pcd as tpcd, tum as ttum


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cams", [1, 2])
def test_cube_scenario_equal(cams):
    for noisy in (True, False):
        a = convert.flatten_ba_data(jsyn.generate_cube_scenario(
            nr_cameras=cams, noisy=noisy, seed=3))
        b = convert.flatten_ba_data(tsyn.generate_cube_scenario(
            nr_cameras=cams, noisy=noisy, seed=3))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(jsyn.ground_truth_trajectories(cams, 6),
                    tsyn.ground_truth_trajectories(cams, 6)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    eye = np.array([3.0, -4.0, 2.0])
    np.testing.assert_array_equal(
        tsyn.lookat_pose(eye, np.zeros(3), [0, 0, 1]),
        jsyn.lookat_pose(eye, np.zeros(3), [0, 0, 1]))
    with pytest.raises(ValueError):
        tsyn.generate_cube_scenario(nr_cameras=3)


def read_outputs(d, name, cams):
    trajs = [jtum.load_trajectory(os.path.join(
        d, f"traj_out.cam{c}-{name}-BA.txt")) for c in range(cams)]
    pts = jpcd.load_pcd(os.path.join(d, f"map_out-{name}-BA.pcd"))[0]
    return trajs, pts


def hold_outputs(dj, dt, name, cams):
    (tj, pj), (tt, pt) = read_outputs(dj, name, cams), \
        read_outputs(dt, name, cams)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_allclose(b.locations, a.locations, atol=1e-4)
        np.testing.assert_allclose(b.quaternions, a.quaternions, atol=1e-5)
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, atol=1e-3)
    # the same layout: header lines and line count
    for f in [f"traj_out.cam{c}-{name}-BA.txt" for c in range(cams)] + [
            f"map_out-{name}-BA.pcd"]:
        la = open(os.path.join(dj, f)).read().splitlines()
        lb = open(os.path.join(dt, f)).read().splitlines()
        assert len(la) == len(lb)
        heads = [x for x in la if x.startswith("#") or x[:1].isalpha()]
        assert heads == [x for x in lb if x.startswith("#")
                         or x[:1].isalpha()]


def test_cli_cube(tmp_path, capsys):
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dt.mkdir()
    args = ["cube", "2", "1", "1", "1", "0", "1", "0", "1"]
    assert jcli.main([str(dj)] + args) == 0
    assert tcli.main([str(dt)] + args + ["--device", "cpu"]) == 0
    hold_outputs(str(dj), str(dt), "cube", 2)
    assert "accepted iterations" in capsys.readouterr().out


def test_cli_dump(tmp_path):
    """A one-camera dump (the cube's first camera, written through the
    port's writers) read back and solved by both CLIs, odometry on."""
    data = tsyn.generate_cube_scenario(nr_cameras=1, seed=5)
    d = tmp_path / "dump"
    d.mkdir()
    tio.save_ba_data(str(d), "run", data)
    poses = data.poses[0]
    ttum.save_trajectory(str(d / "traj_out.cam0-run.txt"),
                         ttum.trajectory_from_extrinsics(
                             np.array([t for _, t in poses]),
                             np.linalg.inv(np.stack([W for W, _ in poses]))))
    tpcd.save_pcd(str(d / "map_out-run.pcd"), data.points3D)
    dj, dt = tmp_path / "jax", tmp_path / "port"
    for out in (dj, dt):
        out.mkdir()
        for f in os.listdir(d):
            (out / f).write_bytes((d / f).read_bytes())
    assert jcli.main([str(dj), "run", "1", "1"]) == 0
    assert tcli.main([str(dt), "run", "1", "1", "--device", "cpu"]) == 0
    hold_outputs(str(dj), str(dt), "run", 1)


@pytest.mark.parametrize("mode", [1, 2])
def test_incremental_modes_refused(tmp_path, capsys, mode):
    """Modes 1 and 2 (the step-batched incremental solve, no polish) on the
    cube through both CLIs: the same output files, held as mode 0's are
    (the whole schedule, ending in a full LM, reaches the same solution;
    ``tests/test_torch_ba_incremental.py`` says why steps between may
    differ).  The name dates from when the port refused these modes; it
    is kept so that the test's history stays one."""
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dt.mkdir()
    args = ["cube", "2", "1", "1", "1", "0", "1", str(mode), "1"]
    assert jcli.main([str(dj)] + args) == 0
    assert tcli.main([str(dt)] + args + ["--device", "cpu"]) == 0
    hold_outputs(str(dj), str(dt), "cube", 2)
    assert "incremental step 19" in capsys.readouterr().out


def test_cli_usage_and_device(tmp_path, capsys, monkeypatch):
    assert tcli.main(["only", "three", "args"]) == 1
    assert "baseDir" in capsys.readouterr().out
    assert tcli.main([str(tmp_path), "cube", "1", "1", "--device"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([str(tmp_path), "cube", "1", "1", "1", "1", "0", "1", "0",
                   "1"])
