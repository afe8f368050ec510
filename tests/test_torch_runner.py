"""``run_frontend`` of both packages on the same synthetic sequence
(320x240, 128 tracks, 10 frames with three keyframes), the JAX key chain's
RANSAC draws replayed into the port.

Tolerances: ``accepted`` equal frame by frame and keyframe count equal (same
draws, same inlier sets); poses 2e-3 (cam-to-world, metres and matrix
entries: the two LK level loops clip a drifting window one way or the other,
20 Gauss-Newton steps in float32 with sums in another order); BA association
and 2D-point counts per frame, and the landmark count, within 3 (a track at
an error or reprojection gate may fall on either side).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ba import validate as jvalidate
from mqslam_tpu.core import camera as jcam
from mqslam_tpu.frontend import runner as jrunner, tracker as jtrk
from mqslam_tpu.io import ba_info as jba

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.frontend import runner as trunner, synthetic as tsyn
from mqslam_tpu_torch.io import ba_info as tba
from mqslam_tpu_torch.ops import features as tfeat
from test_torch_tracker import ransac_scores_from_keys

F, SIZE, PLANE_Z = 250.0, (320, 240), 4.0
CAL9 = np.array([F, F, 0, SIZE[0] / 2, SIZE[1] / 2, 0, 0, 0, 0], np.float32)
N_FRAMES, SEED = 10, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the tier-1 command's parallel workers,
    torch's default threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEBUG_EVERY = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    imgs, P_list, *_ = tsyn.build_sequence(
        n_frames=N_FRAMES, size=SIZE, f=F, plane_z=PLANE_Z, seed=7,
        ang_rate=0.03, vel=(0.5, 0.05, 0.1))
    uv, valid = tfeat.detect_corners(torch.tensor(imgs[0]), max_corners=96,
                                     cell=12)
    uv = uv[valid][:64].numpy().astype(np.float32)
    objp = tsyn.backproject_to_plane(
        uv, P_list[0], F, (SIZE[0] / 2, SIZE[1] / 2), PLANE_Z
    ).astype(np.float32)
    jcfg = jtrk.TrackerConfig(max_tracks=128, target_keypoints=100)
    tcfg = convert.config_from_jax(jcfg)
    jdebug = str(tmp_path_factory.mktemp("jax_debug"))
    jres = jrunner.run_frontend(
        list(imgs), jcam.Cal3DS2.from_array(jnp.asarray(CAL9)), jcfg, uv,
        objp, seed=SEED, t0=1 / 30.0, debug_dir=jdebug,
        debug_every=DEBUG_EVERY)
    scores = ransac_scores_from_keys(
        [jax.random.PRNGKey(SEED)], N_FRAMES - 1, jcfg.ransac_hypotheses,
        jcfg.max_tracks)[:, 0]
    tcal = convert.cal_from_numpy(CAL9, device="cpu")
    stage_ms = {}
    tres = trunner.run_frontend(
        list(imgs), tcal, tcfg, uv, objp, ransac_scores=scores, t0=1 / 30.0,
        device="cpu", stage_ms=stage_ms)
    return dict(jres=jres, tres=tres, imgs=imgs, P_list=P_list, uv=uv,
                objp=objp, tcal=tcal, tcfg=tcfg, scores=scores,
                stage_ms=stage_ms, jdebug=jdebug)


def test_accepted_and_keyframes(runs):
    j, t = runs["jres"], runs["tres"]
    assert t.accepted == j.accepted
    assert t.n_keyframes == j.n_keyframes >= 3
    assert all(a > 0 for a in t.accepted)
    assert t.loop_edges == []
    assert set(runs["stage_ms"]) == {"pyramid", "lk", "track_keyframe",
                                     "refill", "host"}


def test_poses_and_trajectory(runs):
    j, t = runs["jres"], runs["tres"]
    for Pj, Pt in zip(j.poses, t.poses):
        np.testing.assert_allclose(Pt, Pj, atol=2e-3)
    np.testing.assert_array_equal(t.trajectory.timestamps,
                                  j.trajectory.timestamps)
    np.testing.assert_allclose(t.trajectory.locations,
                               j.trajectory.locations, atol=2e-3)
    np.testing.assert_allclose(t.trajectory.quaternions,
                               j.trajectory.quaternions, atol=2e-3)
    # and both follow the known camera path
    c_gt = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in runs["P_list"]])
    c_t = np.stack([P[:3, 3] for P in t.poses])
    assert np.abs(c_t - c_gt).max() < 0.02


def test_map_and_ba_counts(runs):
    j, t = runs["jres"], runs["tres"]
    assert abs(len(t.points3d) - len(j.points3d)) <= 3
    n = min(len(t.points3d), 64)
    np.testing.assert_allclose(t.points3d[:n], j.points3d[:n], atol=1e-5)
    assert t.point_colors.shape == (len(t.points3d),)
    assert t.point_groups.shape == (len(t.points3d),)
    dj, dt = j.ba_data, t.ba_data
    assert dt.nr_steps == dj.nr_steps == N_FRAMES
    for f in range(N_FRAMES):
        assert abs(len(dt.points2D[0][f]) - len(dj.points2D[0][f])) <= 3, f
        assert abs(len(dt.point2D3D_assocs[0][f])
                   - len(dj.point2D3D_assocs[0][f])) <= 3, f
        assert abs(len(dt.point3D_added_idxs[f])
                   - len(dj.point3D_added_idxs[f])) <= 3, f
        assert len(dt.odometry[f]) == len(dj.odometry[f])
        assert dt.odometry_assocs[f] == dj.odometry_assocs[f]
        for Oj, Ot in zip(dj.odometry[f], dt.odometry[f]):
            np.testing.assert_allclose(Ot, Oj, atol=4e-3)
    # frame 0 is bootstrap only: identical
    np.testing.assert_array_equal(dt.points2D[0][0], dj.points2D[0][0])
    np.testing.assert_array_equal(dt.point2D3D_assocs[0][0],
                                  dj.point2D3D_assocs[0][0])
    np.testing.assert_allclose(dt.calibrations[0], dj.calibrations[0])
    for a, b in ((dt.pose_noise[0], dj.pose_noise[0]),
                 (dt.point3D_noise, dj.point3D_noise),
                 (dt.point2D_noise[0], dj.point2D_noise[0]),
                 (dt.odometry_noise[0][0], dj.odometry_noise[0][0])):
        assert a.encode() == b.encode()


def test_dump_passes_the_jax_validators(runs, tmp_path):
    data = runs["tres"].ba_data
    assert jvalidate.validate_data_integrity(data)
    jvalidate.validate_sufficiently_constrained(data)
    # through the files: the port writes, the JAX package reads
    from mqslam_tpu_torch.io import pcd as tpcd, tum as ttum
    tba.save_ba_data(str(tmp_path), "mqslam", data)
    ttum.save_trajectory(tmp_path / "traj_out.cam0-mqslam.txt",
                         runs["tres"].trajectory)
    tpcd.save_pcd(tmp_path / "map_out-mqslam.pcd", runs["tres"].points3d)
    back = jba.load_ba_data(str(tmp_path), "mqslam", nr_cameras=1, fps=30,
                            start_time=0.0)
    assert jvalidate.validate_data_integrity(back)
    assert back.nr_steps == data.nr_steps
    for a, b in zip(back.point2D3D_assocs[0], data.point2D3D_assocs[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(back.points3D, data.points3D, atol=1e-5)


def test_generator_run_and_no_ba(runs):
    """Without injected draws a seeded generator drives RANSAC; without BA
    collection no dump is kept.  Same accepted flags on this clean
    sequence."""
    res = trunner.run_frontend(
        list(runs["imgs"][:5]), runs["tcal"], runs["tcfg"], runs["uv"],
        runs["objp"], generator=torch.Generator().manual_seed(0),
        collect_ba=False, device="cpu")
    assert res.ba_data is None
    assert res.accepted == runs["tres"].accepted[:5]
    assert len(res.trajectory.timestamps) == 5


def test_live_update_writes_files(runs, tmp_path):
    from mqslam_tpu_torch.io import pcd as tpcd, tum as ttum
    traj, mp = str(tmp_path / "live.txt"), str(tmp_path / "live.pcd")
    trunner.run_frontend(
        list(runs["imgs"][:4]), runs["tcal"], runs["tcfg"], runs["uv"],
        runs["objp"], ransac_scores=runs["scores"], collect_ba=False,
        live_update_period=3, traj_out_file=traj, map_out_file=mp,
        device="cpu")
    assert len(ttum.load_trajectory(traj).timestamps) == 4   # frames 0..3
    assert len(tpcd.load_pcd(mp)[0]) >= 64


def test_debug_views_match_the_jax_runner(runs, tmp_path):
    """The same PNGs as the JAX runner (every DEBUG_EVERY-th frame and every
    keyframe), and the trajectory bit-equal to the run without views."""
    from PIL import Image
    dbg = str(tmp_path / "dbg")
    res = trunner.run_frontend(
        list(runs["imgs"]), runs["tcal"], runs["tcfg"], runs["uv"],
        runs["objp"], ransac_scores=runs["scores"], t0=1 / 30.0,
        debug_dir=dbg, debug_every=DEBUG_EVERY, device="cpu")
    names = sorted(os.listdir(dbg))
    assert names == sorted(os.listdir(runs["jdebug"]))
    due = [f for f, a in enumerate(res.accepted)
           if f > 0 and (a != 1 or f % DEBUG_EVERY == 0)]
    assert names == sorted(f"composite{k}d_{f:05d}.png" for f in due
                           for k in (2, 3))
    assert len(due) > N_FRAMES // DEBUG_EVERY         # keyframes drew too
    assert res.accepted == runs["tres"].accepted
    for a, b in zip(res.poses, runs["tres"].poses):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res.points3d, runs["tres"].points3d)
    for n in names:
        im = np.asarray(Image.open(os.path.join(dbg, n)))
        assert im.shape == (SIZE[1], SIZE[0], 3) and im.max() > 0


def test_debug_view_of_a_rejected_frame(runs, tmp_path):
    """A blank frame is rejected (its tracks are lost) and drawn with the
    red border whatever ``debug_every`` says; the run goes on from the
    last accepted frame."""
    from PIL import Image
    imgs = list(runs["imgs"][:4])
    imgs.insert(2, np.full_like(imgs[0], 128.0))
    dbg = str(tmp_path / "dbg")
    res = trunner.run_frontend(
        imgs, runs["tcal"], runs["tcfg"], runs["uv"], runs["objp"],
        generator=torch.Generator().manual_seed(0), collect_ba=False,
        debug_dir=dbg, debug_every=100, device="cpu")
    assert res.accepted[2] == 0 and res.poses[2] is None
    assert all(a > 0 for i, a in enumerate(res.accepted) if i != 2)
    im = np.asarray(Image.open(os.path.join(dbg, "composite2d_00002.png")))
    assert (im[0, :, 0] == 255).all() and (im[0, :, 1] == 0).all()
    assert os.path.exists(os.path.join(dbg, "composite3d_00002.png"))
    for f, a in enumerate(res.accepted):
        drew = os.path.exists(os.path.join(dbg, f"composite2d_{f:05d}.png"))
        assert drew == (f > 0 and a != 1)


def test_needs_a_cuda_device_by_default(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run_frontend(
            list(runs["imgs"][:2]), runs["tcal"], runs["tcfg"], runs["uv"],
            runs["objp"])


def test_fetch_is_exact():
    from mqslam_tpu_torch.frontend.tracker import StepOutput
    g = torch.Generator().manual_seed(1)
    K = 7
    out = StepOutput(
        accepted=torch.tensor(2, dtype=torch.int32),
        rvec=torch.randn(3, generator=g), tvec=torch.randn(3, generator=g),
        cur_uv=torch.randn(K, 2, generator=g),
        track_alive=torch.rand(K, generator=g) > 0.5,
        track_triangulated=torch.rand(K, generator=g) > 0.5,
        objp_idx=torch.arange(K, dtype=torch.int32) * 1000,
        pnp_inlier=torch.rand(K, generator=g) > 0.5,
        new_landmarks=torch.zeros(K, dtype=torch.bool),
        n_tracks=torch.tensor(5), lost_ratio=torch.tensor(0.25),
        homography_condition=torch.tensor(1.05),
        reject_code=torch.tensor(0, dtype=torch.int32))
    got = trunner._fetch(out)
    for name, x, y in zip(out._fields, out, got):
        assert isinstance(y, np.ndarray) and y.shape == tuple(x.shape), name
        np.testing.assert_array_equal(y, x.numpy(), err_msg=name)
