"""The port's ``multiagent`` (``merge_agents``, ``ba_data_from_scan`` and
its Rodrigues) against mqslam_tpu's on the CPU.

Tolerances: the graphs are compared flattened (``convert.
flatten_ba_data``): the same keys, integer and boolean arrays equal,
floating arrays within 1e-12 (both packages do the same float64 NumPy
arithmetic; the dumps' rotations come from OpenCV's Rodrigues in the JAX
package and from the port's own, held to OpenCV's at 1e-12)."""

import types

import cv2
import numpy as np
import pytest
import torch

from mqslam_tpu.ba import synthetic as jsyn
from mqslam_tpu.multiagent import (CrossOdometry as JCross,
                                   ba_data_from_scan as jax_from_scan,
                                   merge_agents as jax_merge)
from mqslam_tpu_torch import convert
from mqslam_tpu_torch.ba import synthetic as tsyn
from mqslam_tpu_torch.frontend import synthetic, tracker as trk
from mqslam_tpu_torch.multiagent import (CrossOdometry, ba_data_from_scan,
                                         merge_agents, scan_to_host)
from mqslam_tpu_torch.multiagent.fleet_dump import rodrigues
from mqslam_tpu_torch.ops import features


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: test files run side by side in parallel
    workers, and one thread each keeps them from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_graph(a, b):
    fa, fb = convert.flatten_ba_data(a), convert.flatten_ba_data(b)
    assert sorted(fa) == sorted(fb)
    for k, x in fa.items():
        y = fb[k]
        assert x.shape == y.shape, k
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-12, err_msg=k)
        else:
            assert np.array_equal(x, y), k


def test_rodrigues_matches_opencv():
    rng = np.random.RandomState(0)
    rvecs = [np.zeros(3), np.array([1e-17, 0, 0]), np.array([0, 1e-9, 0]),
             np.array([np.pi, 0, 0]), np.array([0, 0, -np.pi + 1e-7])]
    rvecs += list(rng.randn(50, 3)) + list(1e-4 * rng.randn(10, 3))
    for r in rvecs:
        np.testing.assert_allclose(rodrigues(r), cv2.Rodrigues(r)[0],
                                   rtol=0, atol=1e-12, err_msg=str(r))


def _agents(gen, n):
    """n single-camera cube runs (``generate_cube_scenario(nr_cameras=1)``
    per agent, seeds 0..n-1)."""
    return [gen.generate_cube_scenario(nr_cameras=1, nr_frames=10, seed=s)
            for s in range(n)]


def _cross(cls, with_sigmas):
    rng = np.random.RandomState(3)
    out = []
    for step, (fa, ta) in enumerate([(0, 1), (1, 2), (0, 2), (0, 1)]):
        M = np.eye(4)
        M[:3, :3] = cv2.Rodrigues(0.1 * rng.randn(3))[0]
        M[:3, 3] = rng.randn(3)
        sig = (np.array([0.002] * 3 + [0.004] * 3) * (step + 1)
               if with_sigmas else None)
        out.append(cls(step=2 * step + 1, from_agent=fa, from_frame=step,
                       to_agent=ta, to_frame=step + 2, measured=M,
                       sigmas=sig))
    return out


def _transforms():
    rng = np.random.RandomState(4)
    out = [np.eye(4)]
    for _ in range(2):
        T = np.eye(4)
        T[:3, :3] = cv2.Rodrigues(0.2 * rng.randn(3))[0]
        T[:3, 3] = 0.1 * rng.randn(3)
        out.append(T)
    return out


@pytest.mark.parametrize("merge_landmarks", [False, True])
@pytest.mark.parametrize("transforms", [False, True])
@pytest.mark.parametrize("with_sigmas", [False, True])
def test_merge_agents_equals_jax(merge_landmarks, transforms, with_sigmas):
    """Three agents; landmark union off / on (radius 1.0: the cube corners
    of the three runs unite, and the greedy union onto the earliest agent
    and the compaction of ids show); identity or rigid agent transforms;
    cross-factors with and without sigmas (a later factor of a pair
    overwrites the pair's noise, as in the JAX package)."""
    jd, td = _agents(jsyn, 3), _agents(tsyn, 3)
    assert_same_graph(jd[0], td[0])
    kw = dict(merge_landmarks=merge_landmarks, merge_radius=1.0,
              agent_transforms=_transforms() if transforms else None)
    jm = jax_merge(jd, cross_odometry=_cross(JCross, with_sigmas), **kw)
    tm = merge_agents(td, cross_odometry=_cross(CrossOdometry, with_sigmas),
                      **kw)
    assert tm.nr_cameras == 3
    assert_same_graph(jm, tm)
    if merge_landmarks:
        assert len(tm.points3D) < sum(len(d.points3D) for d in td)
    else:
        assert len(tm.points3D) == sum(len(d.points3D) for d in td)


N_FRAMES, SIZE, F = 9, (320, 240), 280.0


@pytest.fixture(scope="module")
def fleet_scan():
    """A port fleet scan on the CPU: 2 agents, 9 frames, 320x240,
    ``collect=True``, injected RANSAC draws."""
    torch.manual_seed(0)
    cal = convert.cal_from_numpy([F, F, 0, SIZE[0] / 2, SIZE[1] / 2,
                                  0, 0, 0, 0], device="cpu")
    cfg = trk.TrackerConfig(max_tracks=128, max_landmarks=1024,
                            target_keypoints=90, ransac_hypotheses=64)
    tex = synthetic.make_texture(np.random.RandomState(11))
    states, imgs = [], []
    for a in range(2):
        sgn = 1.0 if a % 2 == 0 else -1.0
        P = []
        for i in range(N_FRAMES):
            Pi = np.eye(4)
            Pi[:3, :3] = rodrigues([0, sgn * 0.05 * i / (N_FRAMES - 1), 0])
            Pi[:3, 3] = -Pi[:3, :3] @ np.array(
                [0.3 * a + sgn * 0.8 * i / (N_FRAMES - 1),
                 0.1 * i / (N_FRAMES - 1), 0.12 * i / (N_FRAMES - 1)])
            P.append(Pi)
        seq = synthetic.render_plane_sequence(np.stack(P), tex, size=SIZE,
                                              f=F)
        uv, valid = features.detect_corners(torch.as_tensor(seq[0]),
                                            max_corners=80, cell=14)
        uv = uv[valid][:64].numpy()
        objp = synthetic.backproject_to_plane(
            uv, P[0], F, (SIZE[0] / 2, SIZE[1] / 2), 4.0)
        states.append(trk.bootstrap(uv, objp.astype(np.float32), cal,
                                    seq[0], cfg, device="cpu"))
        imgs.append(seq)
    init = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
    scores = np.random.RandomState(12).rand(
        N_FRAMES - 1, 2, cfg.ransac_hypotheses, cfg.max_tracks).astype(
            np.float32)
    run = trk.make_multi_agent_runner(cal, cfg, collect=True, device="cpu")
    final, outs = run(init, np.stack(imgs), ransac_scores=scores)
    return cal, init, final, outs


@pytest.mark.parametrize("agent", [0, 1])
def test_ba_data_from_scan_equals_jax(fleet_scan, agent):
    """The port's dump of each agent against the JAX package's
    ``ba_data_from_scan`` applied to the same scan's arrays in NumPy; the
    dump is the same from the tensors and from ``scan_to_host``'s copies."""
    cal, init, final, outs = fleet_scan
    acc = outs[0].numpy()
    assert (acc > 0).all() and (acc == 2).any()     # keyframes: backfills
    h_init, h_final, h_outs = scan_to_host(init, final, outs)
    ns = lambda st: types.SimpleNamespace(**st._asdict())
    jcal = types.SimpleNamespace(as_array=lambda: cal.as_array().numpy())
    ref = jax_from_scan(ns(h_init), ns(h_final), h_outs, jcal, agent,
                        fps=30.0, t0=1 / 30.0)
    got = ba_data_from_scan(h_init, h_final, h_outs, cal, agent,
                            fps=30.0, t0=1 / 30.0)
    assert_same_graph(ref, got)
    assert_same_graph(got, ba_data_from_scan(init, final, outs, cal, agent,
                                             fps=30.0, t0=1 / 30.0))
    assert sum(len(o) for o in got.odometry) >= 1
