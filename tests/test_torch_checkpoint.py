"""Checkpoint / resume of the port's runner (``frontend/checkpoint.py``),
``tests/test_checkpoint.py`` carried over, on the CPU: the run interrupted
at frame 8 and resumed is bit-identical to the uninterrupted one — with the
RANSAC draws injected (the frame cursor is the draws' cursor) and with a
seeded generator (its state is in the checkpoint) — down to the BA
bookkeeping; ``slam_run --checkpoint`` / ``--resume`` round-trips through
files.  Sequence: ``tests/test_frontend.py``'s (320x240, 192 tracks, 16
frames)."""

import os

import numpy as np
import pytest
import torch

from test_frontend import make_sequence, init_from_frame0, CAL, CFG  # noqa
from test_torch_tracker import ransac_scores_from_keys

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.frontend import checkpoint as tckpt
from mqslam_tpu_torch.frontend.runner import run_frontend

N_FRAMES = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small eager ops: one torch thread is as fast, and beside parallel
    test workers many threads a process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    rng = np.random.RandomState(11)
    imgs, P_gt = make_sequence(rng, N_FRAMES)
    uv0, objp0 = init_from_frame0(imgs[0], P_gt[0])
    import jax
    scores = ransac_scores_from_keys([jax.random.PRNGKey(0)], N_FRAMES - 1,
                                     CFG.ransac_hypotheses,
                                     CFG.max_tracks)[:, 0]
    return dict(imgs=list(imgs), uv0=uv0, objp0=objp0, scores=scores,
                cal=convert.cal_from_numpy(np.asarray(CAL.as_array()),
                                           device="cpu"),
                cfg=convert.config_from_jax(CFG))


def _run(seq, n=N_FRAMES, **kw):
    return run_frontend(seq["imgs"][:n], seq["cal"], seq["cfg"], seq["uv0"],
                        seq["objp0"], fps=30.0, collect_ba=True,
                        device="cpu", **kw)


def _hold_identical(resumed, full):
    assert resumed.accepted == full.accepted
    assert len(resumed.poses) == len(full.poses)
    for a, b in zip(resumed.poses, full.poses):
        if a is None or b is None:
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed.points3d, full.points3d)
    ra, fa = resumed.ba_data, full.ba_data
    fr, ff = convert.flatten_ba_data(ra), convert.flatten_ba_data(fa)
    assert fr.keys() == ff.keys()
    for k in ff:
        np.testing.assert_array_equal(fr[k], ff[k], err_msg=k)


def test_resume_is_bit_identical_with_injected_draws(seq, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    full = _run(seq, ransac_scores=seq["scores"])
    assert sum(a == 2 for a in full.accepted) >= 3
    # interrupted run: checkpoint at frame 8, discard the rest
    _run(seq, n=9, ransac_scores=seq["scores"], checkpoint_every=8,
         checkpoint_path=ckpt)
    assert os.path.exists(ckpt)
    resumed = _run(seq, ransac_scores=seq["scores"], resume_from=ckpt)
    _hold_identical(resumed, full)


def test_resume_is_bit_identical_with_a_generator(seq, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    gen = lambda: torch.Generator().manual_seed(5)
    full = _run(seq, generator=gen())
    _run(seq, n=9, generator=gen(), checkpoint_every=8,
         checkpoint_path=ckpt)
    resumed = _run(seq, generator=gen(), resume_from=ckpt)
    _hold_identical(resumed, full)


def test_checkpoint_contents(seq, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    gen = torch.Generator().manual_seed(5)
    _run(seq, n=5, generator=gen, checkpoint_every=2, checkpoint_path=ckpt)
    with np.load(ckpt) as z:
        assert int(z["__version"]) == 1 and int(z["frame_idx"]) == 4
        assert z["prev_img"].shape == (240, 320)
        np.testing.assert_array_equal(z["prev_img"], seq["imgs"][4])
        assert "rng_generator" in z.files
        assert "rng_loop_generator" not in z.files
        assert {f"state_{k}" for k in ("cur_uv", "objp", "n_objp")} <= set(
            z.files)
    state, frame_idx, prev, poses, accepted, bk, rng = \
        tckpt.load_checkpoint(ckpt, device="cpu")
    assert frame_idx == 4 and len(poses) == len(accepted) == 5
    assert torch.equal(rng["generator"], gen.get_state())
    assert state.objp.dtype == torch.float32 and state.active.dtype == \
        torch.bool
    data, history, last_kf = bk
    assert data.nr_steps == 5 and history and last_kf <= 4


def test_loop_closure_checkpoint_keeps_its_generator(seq, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    _run(seq, n=5, generator=torch.Generator().manual_seed(5),
         loop_closure=True, checkpoint_every=4, checkpoint_path=ckpt)
    *_, rng = tckpt.load_checkpoint(ckpt, device="cpu")
    assert set(rng) == {"generator", "loop_generator"}
    assert torch.equal(rng["loop_generator"],
                       torch.Generator().manual_seed(6).get_state())


def test_version_is_checked(seq, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    _run(seq, n=3, ransac_scores=seq["scores"], checkpoint_every=2,
         checkpoint_path=ckpt)
    with np.load(ckpt) as z:
        fields = dict(z)
    fields["__version"] = np.int32(99)
    np.savez(str(tmp_path / "bad.npz"), **fields)
    with pytest.raises(ValueError, match="version 99"):
        tckpt.load_checkpoint(str(tmp_path / "bad.npz"), device="cpu")


def test_resume_rejects_loop_closure(seq, tmp_path):
    with pytest.raises(ValueError):
        _run(seq, n=4, loop_closure=True,
             resume_from=str(tmp_path / "x.npz"))


def test_slam_run_checkpoint_and_resume(seq, tmp_path):
    """The command line over PNG files: a run cut at frame 8 with
    ``--checkpoint`` and resumed with ``--resume`` writes the trajectory,
    map and dump of the uninterrupted run."""
    from PIL import Image
    from mqslam_tpu_torch.cli import slam_run
    from mqslam_tpu_torch.io import intrinsics, pcd
    d = tmp_path / "seq"
    os.makedirs(d / "frames")
    os.makedirs(d / "cut")
    imgs8 = [np.clip(np.rint(im), 0, 255).astype(np.uint8)
             for im in seq["imgs"]]
    for i, im in enumerate(imgs8):
        Image.fromarray(im).save(d / "frames" / f"frame-{i:02d}.png")
        if i <= 8:
            Image.fromarray(im).save(d / "cut" / f"frame-{i:02d}.png")
    cal = np.asarray(CAL.as_array())
    K = np.array([[cal[0], 0, cal[3]], [0, cal[1], cal[4]], [0, 0, 1]])
    intrinsics.save_camera_intrinsics(d / "camera_intrinsics.txt", K,
                                      np.zeros(5), (320, 240))
    rng = np.random.RandomState(11)
    _, P_gt = make_sequence(rng, N_FRAMES)
    np.savetxt(d / "init_pose.txt", P_gt[0])
    pcd.save_pcd(d / "init_points.pcd", seq["objp0"])

    def cli(frames, out, *extra):
        os.makedirs(out, exist_ok=True)
        return slam_run.main([
            str(d / frames), str(d / "camera_intrinsics.txt"),
            "--init-pose", str(d / "init_pose.txt"),
            "--init-points", str(d / "init_points.pcd"),
            "--traj-out", str(out / "traj.txt"),
            "--map-out", str(out / "map.pcd"), "--ba-info-dir", str(out),
            "--max-tracks", "192", "--target-keypoints", "120",
            "--device", "cpu", "--quiet", *extra])

    ck = str(tmp_path / "ck.npz")
    assert cli("frames", tmp_path / "full") == 0
    assert cli("cut", tmp_path / "cut", "--checkpoint", ck,
               "--checkpoint-every", "8") == 0
    assert os.path.exists(ck)
    assert cli("frames", tmp_path / "resumed", "--checkpoint", ck,
               "--resume") == 0
    for name in sorted(os.listdir(tmp_path / "full")):
        a = (tmp_path / "full" / name).read_bytes()
        b = (tmp_path / "resumed" / name).read_bytes()
        assert a == b, name
