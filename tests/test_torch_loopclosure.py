"""Loop closure of both packages on the same NumPy inputs, on the CPU: the
keyframe DB (``frontend/loopclosure.py``), the runner's pose-graph
correction and ``run_frontend(loop_closure=True)``, and ``cli/loop_demo``.

Tolerances: ``add_keyframe`` and ``loop_scores`` (counts, ``i1``, ``good``)
and ``best_candidate`` equal (integers; the Hamming matmul is exact);
``verify_loop`` with the JAX draws passed in: ``n_inl`` and ``ok`` equal,
``rvec`` / ``tvec`` 2e-3 (5 + 5 Gauss-Newton steps in float32);
``relative_edge`` 1e-5; ``_pgo_correct`` 1e-3 (``pgo_solve``'s bound).
The whole runner on ``tests/test_posegraph.py``'s out-and-back sequence
(24 frames, 320x240, 256 tracks) with the JAX RANSAC and loop draws
replayed: the same ``(cand, kf)`` loop edges, edge measurements 5e-3,
corrected centres 5e-3 m from the JAX run's and within the JAX test's
0.05 m RMSE of the truth (the runners' LK semantics differ, ROADMAP
Queue 3, so the poses before correction differ by up to ~2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from mqslam_tpu.core import camera as jcam
from mqslam_tpu.frontend import loopclosure as jlc, runner as jrunner
from mqslam_tpu.frontend import synthetic as jsyn, tracker as jtrk
from mqslam_tpu.ops import features as jfeat, orb as jorb

from mqslam_tpu_torch import convert
from mqslam_tpu_torch.cli import loop_demo
from mqslam_tpu_torch.frontend import loopclosure as tlc
from mqslam_tpu_torch.frontend import runner as trunner
from mqslam_tpu_torch.ops import orb as torb
from test_torch_tracker import ransac_scores_from_keys


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small eager ops: one torch thread is as fast, and beside parallel
    test workers many threads a process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed):
    rng = np.random.RandomState(seed)
    img = ndi.gaussian_filter(rng.rand(240, 320), 1.5)
    return ((img - img.min()) / np.ptp(img) * 255).astype(np.float32)


def _np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _hold_db(tdb, jdb):
    got = convert.keyframe_db_to_numpy(tdb)
    for k, v in _np_fields(jdb).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype, k


def _random_keyframe(rng, K):
    return (rng.randint(0, 256, (K, 32), np.uint8), rng.rand(K) > 0.2,
            rng.rand(K, 2).astype(np.float32) * 300,
            rng.randn(K, 3).astype(np.float32), rng.rand(K) > 0.5,
            rng.randn(6).astype(np.float32))


@pytest.mark.parametrize("capacity, n_add", [(4, 3), (3, 5)])
def test_add_keyframe_equal(capacity, n_add):
    """In place, field by field, including past capacity (a no-op)."""
    K = 16
    rng = np.random.RandomState(capacity)
    jdb = jlc.empty_db(capacity, K)
    tdb = tlc.empty_db(capacity, K, device="cpu")
    _hold_db(tdb, jdb)
    for _ in range(n_add):
        kf = _random_keyframe(rng, K)
        jdb = jlc.add_keyframe(jdb, *(jnp.asarray(x) for x in kf))
        before = tdb.desc.data_ptr()
        tdb = tlc.add_keyframe(tdb, *(torch.tensor(x) for x in kf))
        assert tdb.desc.data_ptr() == before     # written in place
        _hold_db(tdb, jdb)
    assert int(tdb.count) == min(capacity, n_add)


@pytest.fixture(scope="module")
def scene_db():
    """Four keyframes of ORB features (the last revisits the first) in
    both packages' DBs, plus the query."""
    K = 128
    imgs = [_scene(s) for s in (1, 2, 3, 1)]
    jdb = jlc.empty_db(capacity=8, k=K)
    feats = []
    for im in imgs:
        uv, desc, _, _, valid = jorb.orb_features(jnp.asarray(im),
                                                  max_corners=K,
                                                  threshold=4.0)
        feats.append((np.asarray(uv), np.asarray(desc), np.asarray(valid)))
        jdb = jlc.add_keyframe(jdb, desc, valid, uv, jnp.zeros((K, 3)),
                               jnp.zeros(K, bool), jnp.zeros(6))
    tdb = convert.keyframe_db_from_numpy(_np_fields(jdb), device="cpu")
    return dict(jdb=jdb, tdb=tdb, feats=feats, K=K)


@pytest.mark.parametrize("cur_index, min_gap, max_dist, ratio", [
    (3, 2, 64, 0.8), (3, 1, 64, 0.8), (10, 2, 40, 0.7), (3, 4, 64, 0.8)])
def test_loop_scores_equal(scene_db, cur_index, min_gap, max_dist, ratio):
    _, desc, valid = scene_db["feats"][3]
    want = jlc.loop_scores(scene_db["jdb"], jnp.asarray(desc),
                           jnp.asarray(valid), cur_index=jnp.int32(cur_index),
                           min_gap=min_gap, max_dist=max_dist, ratio=ratio)
    got = tlc.loop_scores(scene_db["tdb"], torch.tensor(desc),
                          torch.tensor(valid), cur_index=cur_index,
                          min_gap=min_gap, max_dist=max_dist, ratio=ratio)
    for name, w, g in zip(("scores", "i1", "good"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    scores = got[0].numpy()
    eligible = np.arange(8) <= cur_index - min_gap
    assert (scores[~eligible] == 0).all()
    if eligible[0]:   # the revisited place beats the other places
        assert scores[0] > 2 * scores[1:3].max()
    for m in (20, 10_000):
        jc, jf = jlc.best_candidate(jnp.asarray(np.asarray(want[0])), m)
        tc, tf = tlc.best_candidate(got[0], m)
        assert (int(tc), bool(tf)) == (int(jc), bool(jf))


def test_loop_scores_ties_and_masks():
    """Random DB with near-duplicate descriptors (many tied distances)
    and masked slots: the same integers."""
    rng = np.random.RandomState(6)
    N, K = 6, 48
    desc = rng.randint(0, 256, (N, K, 32), np.uint8)
    q = desc[1].copy()
    q[::3, 0] ^= 1
    desc[4] = desc[1]
    fields = dict(desc=desc, desc_valid=rng.rand(N, K) > 0.3,
                  uv=np.zeros((N, K, 2), np.float32),
                  xyz=np.zeros((N, K, 3), np.float32),
                  xyz_valid=np.zeros((N, K), bool),
                  pose=np.zeros((N, 6), np.float32),
                  used=np.array([1, 1, 1, 1, 1, 0], bool),
                  count=np.int32(5))
    q_valid = rng.rand(K) > 0.1
    jdb = jlc.KeyframeDB(**{k: jnp.asarray(v) for k, v in fields.items()})
    tdb = convert.keyframe_db_from_numpy(fields, device="cpu")
    want = jlc.loop_scores(jdb, jnp.asarray(q), jnp.asarray(q_valid),
                           cur_index=jnp.int32(8), min_gap=3)
    got = tlc.loop_scores(tdb, torch.tensor(q), torch.tensor(q_valid),
                          cur_index=8, min_gap=3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][1]) > 0 and int(got[0][5]) == 0


@pytest.fixture(scope="module")
def revisit():
    """``test_posegraph.py::test_verify_and_edge``: landmarks on a plane,
    a keyframe at the origin and a slightly moved revisit."""
    rng = np.random.RandomState(4)
    tex = jsyn.make_texture(rng)
    f, size, plane_z = 300.0, (320, 240), 4.0
    cal9 = np.array([f, f, 0, size[0] / 2, size[1] / 2, 0, 0, 0, 0],
                    np.float32)
    P0 = np.eye(4)
    Pq = np.eye(4)
    Pq[:3, 3] = [-0.1, 0.05, 0.15]
    imgs = jsyn.render_plane_sequence(np.stack([P0, Pq]), tex, size=size,
                                      f=f, plane_z=plane_z)
    K = 128
    uv0, desc0, _, _, v0 = jorb.orb_features(jnp.asarray(imgs[0]),
                                             max_corners=K, threshold=4.0)
    xyz0 = jsyn.backproject_to_plane(np.asarray(uv0), P0, f,
                                     (size[0] / 2, size[1] / 2), plane_z)
    jdb = jlc.add_keyframe(jlc.empty_db(capacity=4, k=K), desc0, v0, uv0,
                           jnp.asarray(xyz0.astype(np.float32)), v0,
                           jnp.zeros(6))
    uvq, descq, _, _, vq = jorb.orb_features(jnp.asarray(imgs[1]),
                                             max_corners=K, threshold=4.0)
    scores, i1, good = jlc.loop_scores(jdb, descq, vq,
                                       cur_index=jnp.int32(10), min_gap=2)
    cand, found = jlc.best_candidate(scores, min_matches=15)
    assert bool(found) and int(cand) == 0
    return dict(jdb=jdb, cand=cand, i1=i1, good=good, uvq=uvq, vq=vq,
                cal9=cal9, Pq=Pq, K=K)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_loop_equal(revisit, seed):
    r = revisit
    key = jax.random.PRNGKey(seed)
    want = jlc.verify_loop(r["jdb"], r["cand"], r["i1"], r["good"],
                           r["uvq"], r["vq"],
                           jcam.Cal3DS2.from_array(jnp.asarray(r["cal9"])),
                           key)
    tdb = convert.keyframe_db_from_numpy(_np_fields(r["jdb"]), device="cpu")
    t = lambda x: torch.tensor(np.asarray(x))
    draws = np.asarray(jax.random.uniform(key, (128, r["K"])))
    got = tlc.verify_loop(tdb, t(r["cand"]), t(r["i1"]), t(r["good"]),
                          t(r["uvq"]), t(r["vq"]),
                          convert.cal_from_numpy(r["cal9"], device="cpu"),
                          scores=torch.tensor(draws))
    assert int(got[2]) == int(want[2])
    assert bool(got[3]) == bool(want[3]) is True
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-3)
    # the edge recovers the ground-truth query pose
    mr, mt = tlc.relative_edge(tdb.pose[int(r["cand"])], got[0], got[1])
    cq_gt = -(r["Pq"][:3, :3].T @ r["Pq"][:3, 3])
    assert np.linalg.norm(mt.numpy() - cq_gt) < 0.05
    assert np.linalg.norm(mr.numpy()) < 0.02


def test_verify_loop_generator_draws(revisit):
    """Without scores a generator draws; its run repeats."""
    r = revisit
    tdb = convert.keyframe_db_from_numpy(_np_fields(r["jdb"]), device="cpu")
    t = lambda x: torch.tensor(np.asarray(x))
    cal = convert.cal_from_numpy(r["cal9"], device="cpu")
    runs = [tlc.verify_loop(tdb, t(r["cand"]), t(r["i1"]), t(r["good"]),
                            t(r["uvq"]), t(r["vq"]), cal,
                            generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert bool(runs[0][3])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_relative_edge_equal():
    rng = np.random.RandomState(8)
    for _ in range(5):
        pose_i6 = (rng.randn(6) * [0.5, 0.5, 0.5, 2, 2, 2]).astype(
            np.float32)
        rq = (rng.randn(3) * 0.7).astype(np.float32)
        tq = rng.randn(3).astype(np.float32)
        want = jlc.relative_edge(jnp.asarray(pose_i6), jnp.asarray(rq),
                                 jnp.asarray(tq))
        got = tlc.relative_edge(torch.tensor(pose_i6), torch.tensor(rq),
                                torch.tensor(tq))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_pose6_from_w2c_equal():
    rng = np.random.RandomState(9)
    rv = (rng.randn(3) * 0.6).astype(np.float32)
    tv = rng.randn(3).astype(np.float32)
    np.testing.assert_allclose(trunner._pose6_from_w2c(rv, tv),
                               jrunner._pose6_from_w2c(rv, tv), atol=1e-6)


def _drifting_chain(n_kf=12, seed=0):
    """Keyframe poses (4x4 cam-to-world) along a loop with drift, frames
    between them, and one loop edge back to the start."""
    rng = np.random.RandomState(seed)
    poses, kf_frames = [], []
    for k in range(n_kf):
        a = 2 * np.pi * k / n_kf
        P = np.eye(4)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        P[:3, :3] = R
        P[:3, 3] = [3 * np.sin(a), 0.02 * k, 3 * (1 - np.cos(a))]
        P[:3, 3] += rng.randn(3) * 0.03 * k
        kf_frames.append(len(poses))
        poses.append(P)
        for _ in range(2):        # two tracked frames after each keyframe
            Q = P.copy()
            Q[:3, 3] += rng.randn(3) * 0.05
            poses.append(Q)
    poses[4] = None               # a rejected frame keeps its hole
    edge = (0, n_kf - 1, np.array([0.0, -0.5, 0.0], np.float32),
            np.array([1.5, 0.0, -0.1], np.float32))
    return poses, kf_frames, [edge]


def test_pgo_correct_equal():
    poses, kf_frames, edges = _drifting_chain()
    want_p, want_T = jrunner._pgo_correct(poses, kf_frames, edges)
    got_p, got_T = trunner._pgo_correct(poses, kf_frames, edges,
                                        device="cpu")
    np.testing.assert_allclose(got_T, want_T, atol=1e-3)
    assert len(got_p) == len(want_p)
    for a, b in zip(got_p, want_p):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, atol=1e-3)
    assert np.abs(got_T[-1] - np.eye(4)).max() > 0.01   # it moved


# ------------------------------------------------- the runner, end to end

N_OUT, SEED = 12, 0


@pytest.fixture(scope="module")
def out_and_back():
    """``tests/test_posegraph.py``'s out-and-back sequence through both
    runners with loop closure on, the JAX draws replayed into the port."""
    rng = np.random.RandomState(7)
    tex = jsyn.make_texture(rng)
    f, size, plane_z = 400.0, (320, 240), 4.0
    offs = list(np.linspace(0, 0.9, N_OUT)) + \
        list(np.linspace(0.9, 0.0, N_OUT))
    P_list = []
    for i, ox in enumerate(offs):
        P = np.eye(4)
        P[:3, 3] = [-ox, 0.02 * np.sin(i), 0.0]
        P_list.append(P)
    P_list = np.stack(P_list)
    imgs = jsyn.render_plane_sequence(P_list, tex, size=size, f=f,
                                      plane_z=plane_z)
    cal9 = np.array([f, f, 0, size[0] / 2, size[1] / 2, 0, 0, 0, 0],
                    np.float32)
    jcfg = jtrk.TrackerConfig(max_tracks=256, target_keypoints=200)
    uv, valid = jfeat.detect_corners(jnp.asarray(imgs[0]), max_corners=128,
                                     cell=12)
    uv = np.asarray(uv)[np.asarray(valid)][:96].astype(np.float32)
    objp = jsyn.backproject_to_plane(
        uv, P_list[0], f, (size[0] / 2, size[1] / 2), plane_z
    ).astype(np.float32)
    kw = dict(collect_ba=False, loop_closure=True, loop_min_gap=2,
              loop_min_matches=15)
    jres = jrunner.run_frontend(
        list(imgs), jcam.Cal3DS2.from_array(jnp.asarray(cal9)), jcfg, uv,
        objp, seed=SEED, **kw)
    n = len(imgs) - 1
    scores = ransac_scores_from_keys([jax.random.PRNGKey(SEED)], n,
                                     jcfg.ransac_hypotheses,
                                     jcfg.max_tracks)[:, 0]
    loop_scores, key = [], jax.random.PRNGKey(SEED + 1)
    for _ in range(n):
        key, k2 = jax.random.split(key)
        loop_scores.append(np.asarray(jax.random.uniform(
            k2, (128, jcfg.max_tracks))))
    tres = trunner.run_frontend(
        list(imgs), convert.cal_from_numpy(cal9, device="cpu"),
        convert.config_from_jax(jcfg), uv, objp, ransac_scores=scores,
        loop_ransac_scores=np.stack(loop_scores), device="cpu", **kw)
    return dict(jres=jres, tres=tres, P_list=P_list)


def test_runner_loop_edges_equal(out_and_back):
    j, t = out_and_back["jres"], out_and_back["tres"]
    assert t.accepted == j.accepted
    assert t.n_keyframes == j.n_keyframes >= 4
    assert len(t.loop_edges) >= 1, "no loop closure fired"
    assert [e[:2] for e in t.loop_edges] == [e[:2] for e in j.loop_edges]
    for (_, _, rt, tt), (_, _, rj, tj) in zip(t.loop_edges, j.loop_edges):
        np.testing.assert_allclose(rt, rj, atol=5e-3)
        np.testing.assert_allclose(tt, tj, atol=5e-3)


def test_runner_corrected_trajectory(out_and_back):
    j, t = out_and_back["jres"], out_and_back["tres"]
    errs = []
    for i, (Pt, Pj) in enumerate(zip(t.poses, j.poses)):
        assert (Pt is None) == (Pj is None)
        if Pt is None:
            continue
        np.testing.assert_allclose(Pt[:3, 3], Pj[:3, 3], atol=5e-3)
        P = out_and_back["P_list"][i]
        errs.append(np.linalg.norm(Pt[:3, 3] + P[:3, :3].T @ P[:3, 3]))
    assert np.sqrt(np.mean(np.square(errs))) < 0.05
    # landmarks moved with their keyframes
    assert t.points3d.shape == j.points3d.shape
    np.testing.assert_allclose(t.points3d, j.points3d, atol=5e-3)
    np.testing.assert_allclose(t.trajectory.locations,
                               j.trajectory.locations, atol=5e-3)


def test_keyframe_db_round_trip(scene_db):
    f = convert.keyframe_db_to_numpy(scene_db["tdb"])
    for k, v in _np_fields(scene_db["jdb"]).items():
        np.testing.assert_array_equal(f[k], v, err_msg=k)


def test_loop_demo_runs_small():
    """48 frames (the circuit's steps are then too long to track past the
    first frames, in both packages: the run still has to finish)."""
    ate_off, ate_on, n_edges, results = loop_demo.run(
        n_frames=48, verbose=False, device="cpu")
    assert isinstance(ate_off, float) and isinstance(ate_on, float)
    assert np.isfinite(ate_off) and np.isfinite(ate_on)
    assert isinstance(n_edges, int) and n_edges == len(
        results[True].loop_edges)
    assert set(results) == {False, True}
    for res in results.values():
        assert isinstance(res, trunner.FrontendResult)
        assert len(res.accepted) == 48 and res.accepted[0] == 2


def test_circuit_trajectory_closes():
    gt = loop_demo.circuit_trajectory(40)
    assert gt.shape == (40, 4, 4)
    from mqslam_tpu.cli import loop_demo as jdemo
    np.testing.assert_array_equal(gt, jdemo.circuit_trajectory(40))
