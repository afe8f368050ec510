"""mqslam_tpu_torch.datasets against mqslam_tpu.datasets on the CPU: the
JAX tests' cases (tests/test_datasets.py) through both packages.  The
ICL-NUIM adapter is NumPy in both: its POV, OBJ and TUM outputs are
bit-equal.  The SVO plane initialisation runs the detector in each
package: the same count and uv, objp within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.core import camera as jcam
from mqslam_tpu.datasets import icl_nuim as jicl, svo as jsvo
from mqslam_tpu.io import tum as jtum
from mqslam_tpu_torch.core import camera as tcam
from mqslam_tpu_torch.datasets import icl_nuim as ticl, svo as tsvo
from mqslam_tpu_torch.frontend import synthetic
from mqslam_tpu_torch.io import tum as ttum


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_traj_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("rebuild,initial", [(True, None),
                                             (False, (0.5, -1.0, 2.0))])
def test_repair_cam_trajectory(rng, rebuild, initial):
    n = 7
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    args = (rng.rand(n) * 10, rng.randn(n, 3), q)
    kw = dict(initial_location=initial, rebuild_timestamps=rebuild,
              delta_timestamp=0.25, fps=30)
    got = ticl.repair_cam_trajectory(ttum.CamTrajectory(*args), **kw)
    want = jicl.repair_cam_trajectory(jtum.CamTrajectory(*args), **kw)
    assert isinstance(got, ttum.CamTrajectory)
    assert_traj_equal(got, want)
    # the JAX test's case: z-flip (plus the shift to ``initial``) and
    # (qw, qz, qy, -qx)
    shift = 0.0 if initial is None else initial[2] - args[1][0, 2]
    np.testing.assert_allclose(got.locations[:, 2], -args[1][:, 2] + shift,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.quaternions[0],
                                  [q[0, 3], q[0, 2], q[0, 1], -q[0, 0]])


def pov_line(rng):
    keys = [f"{i}{j}" for i in range(4) for j in range(3)]
    return "povray +Ix.pov " + "".join(
        f"+ Declare=val{k}={float(v)!r}+ " for k, v in zip(keys, rng.randn(12)))


def test_load_cam_poses_pov(rng, tmp_path):
    f = tmp_path / "cmds.sh"
    f.write_text("\n".join(pov_line(rng) for _ in range(3)) + "\n")
    got = ticl.load_cam_poses_pov(str(f))
    assert got.shape == (3, 4, 4)
    np.testing.assert_array_equal(got, jicl.load_cam_poses_pov(str(f)))
    # the JAX test's known pose: cam-to-world [I | (1, 2, 3)]
    vals = dict(zip([f"{i}{j}" for i in range(4) for j in range(3)],
                    [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0, 1.0, 2.0, 3.0]))
    f.write_text("povray +Ix.pov " + "".join(
        f"+ Declare=val{k}={v}+ " for k, v in vals.items()) + "\n")
    np.testing.assert_array_equal(ticl.load_cam_poses_pov(str(f))[0][:3, 3],
                                  [-1.0, -2.0, -3.0])


def test_mirror_wavefront_obj(tmp_path):
    fin = tmp_path / "a.obj"
    fin.write_text("# scene\nv 1.0 2.0 3.0\nvn 0.5 0 0\nv -2.5 1 1\n"
                   "vt 0.1 0.2\nf 1 2 3\n")
    ticl.mirror_wavefront_obj(str(fin), str(tmp_path / "t.obj"))
    jicl.mirror_wavefront_obj(str(fin), str(tmp_path / "j.obj"))
    got = (tmp_path / "t.obj").read_bytes()
    assert got == (tmp_path / "j.obj").read_bytes()
    assert b"v -1.0 2.0 3.0" in got and b"vn -0.5 0 0" in got
    assert b"v 2.5 1 1" in got and b"f 1 2 3" in got


def test_normalize_groundtruth(rng, tmp_path):
    q = rng.randn(5, 4) * 3
    args = (np.arange(5) / 30.0, rng.randn(5, 3), q)
    got = tsvo.normalize_groundtruth(ttum.CamTrajectory(*args))
    want = jsvo.normalize_groundtruth(jtum.CamTrajectory(*args))
    assert_traj_equal(got, want)
    # through the TUM writers: the same bytes
    ttum.save_trajectory(str(tmp_path / "t.txt"), got)
    jtum.save_trajectory(str(tmp_path / "j.txt"), want)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("target", [60, 25])
def test_plane_initialization(rng, target):
    """The JAX test's scene (320x240, f = 280, camera 2 units along z from
    the z = 4 plane)."""
    tex = synthetic.make_texture(rng)
    P0 = np.eye(4)
    P0[2, 3] = 2.0
    img = synthetic.render_plane_sequence(P0[None], tex, size=(320, 240),
                                          f=280.0, plane_z=4.0)[0]
    c9 = np.asarray([280.0, 280.0, 0, 160, 120, 0, 0, 0, 0], np.float32)
    juv, jobjp = jsvo.initialize_from_plane(
        img, P0, jcam.Cal3DS2.from_array(jnp.asarray(c9)),
        target_features=target, plane_z=4.0)
    tcal = tcam.Cal3DS2.from_array(torch.tensor(c9))
    uv, objp = tsvo.initialize_from_plane(img, P0, tcal,
                                          target_features=target,
                                          plane_z=4.0, device="cpu")
    assert uv.dtype == objp.dtype == np.float32
    assert len(uv) == len(juv) and 0.6 * target <= len(uv) <= target
    np.testing.assert_array_equal(uv, juv)
    np.testing.assert_allclose(objp, jobjp, atol=1e-4)
    np.testing.assert_allclose(objp[:, 2], 4.0, atol=1e-5)
    # the back-projected points reproject onto the pixels (the JAX test)
    proj, depth = tcam.project(torch.tensor(objp),
                               torch.tensor(P0, dtype=torch.float32), tcal)
    np.testing.assert_allclose(proj.numpy(), uv, atol=1e-2)
    assert (depth > 0).all()
