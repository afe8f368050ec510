"""mqslam_tpu_torch.studies.triangulation_comparison against the JAX
package's study on the CPU: the host side (points, trajectories, the noise
basis and the observations) bit-equal, the median helper equal to
``np.median``, and the device side (``_eval_traj_summaries``, ``test_1and2``,
``test_3``) under the bounds ``chip_smoke.py`` holds the card's study to
against the checked-in goldens.

Small baselines (poses below the baseline of pose 12 of the study's 40) are
roundoff-chaotic in both packages, as is the linear-LS pseudo-inverse's rank
decision at trajectory 4's 90-degree end pose: there only what both runs
reproduce is held (see ``hold_1and2``).

The module's public functions are named ``test_*``: import the module, never
the names, or pytest collects the whole study.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from mqslam_tpu.ops import triangulation as jtri
from mqslam_tpu.studies import triangulation_comparison as jtc
from mqslam_tpu_torch.ops import triangulation as ttri
from mqslam_tpu_torch.studies import triangulation_comparison as tc

F32 = np.float32
STATS = ("err3D_mean", "err3D_median", "err2D_mean", "err2D_median",
         "false_pos", "false_neg")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_points():
    # radius-4 integer sphere: 257 points (the reference's N for the study)
    assert len(tc.finite_points(4)) == 257
    for args in ((4,), (3,), (2, True, False, True)):
        np.testing.assert_array_equal(tc.finite_points(*args),
                                      jtc.finite_points(*args))
    inf = tc.infinite_points(4, math.pi / 4)
    assert np.all(inf[:, 3] == 0)
    np.testing.assert_array_equal(inf, jtc.infinite_points(4, math.pi / 4))


def test_trajectories_and_cameras():
    for kw in ({}, dict(num_poses=16), dict(offset=30.0, max_towards=8.0)):
        for a, b in zip(tc.make_trajectories(**kw),
                        jtc.make_trajectories(**kw)):
            assert a.keys() == b.keys() and a["traj_descr"] == b[
                "traj_descr"]
            for k in ("sideways_values", "towards_values", "angle_values"):
                np.testing.assert_array_equal(a[k], b[k])
    pts = tc.finite_points(3)
    for k1 in (0.0, 0.3):
        cam, jcam = tc.StudyCamera((640, 480), k1), jtc.StudyCamera(
            (640, 480), k1)
        P = tc.StudyCamera.pose(40.0, 5.0, 2.0, 0.3)
        np.testing.assert_array_equal(P, jtc.StudyCamera.pose(40.0, 5.0, 2.0,
                                                              0.3))
        np.testing.assert_array_equal(cam.project_exact(pts, P),
                                      jcam.project_exact(pts, P))
        np.testing.assert_array_equal(cam.cal.as_array().numpy(),
                                      np.asarray(jcam.cal.as_array()))


def test_noise_basis_and_observations_bit_equal():
    """The reference's draw order (seed reset per pose, cam1 then cam2 per
    trial) in both packages, and the device path's basis reproduces it."""
    for n in (19, 257):
        for a, b in zip(tc._noise_basis(n), jtc._noise_basis(n)):
            np.testing.assert_array_equal(a, b)
    pts = tc.finite_points(2)
    cam1 = tc.StudyCamera((640, 480), 0.3)
    cam2 = tc.StudyCamera((640, 480), 0.3)
    P1 = tc.StudyCamera.pose(40.0)
    P2s = [tc.StudyCamera.pose(40.0, 5.0), tc.StudyCamera.pose(40.0, 8.0)]
    for sigma, disc in ((0.8, True), (0.8, False), (0.0, True)):
        got = tc._observations_for_poses(cam1, cam2, P1, P2s, pts, sigma,
                                         disc)
        want = jtc._observations_for_poses(cam1, cam2, P1, P2s, pts, sigma,
                                           disc)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    u1, u2, _ = tc._observations_for_poses(cam1, cam2, P1, P2s, pts, 0.8,
                                           True)
    Z1, Z2 = tc._noise_basis(len(pts))
    exact2 = np.stack([cam2.project_exact(pts, P) for P in P2s])
    np.testing.assert_array_equal(
        np.rint(cam1.project_exact(pts, P1)[None] + 0.8 * Z1), u1[0])
    np.testing.assert_array_equal(np.rint(exact2[:, None] + 0.8 * Z2[None]),
                                  u2)


def test_sigma_zero_draws_nothing():
    """sigma = 0 must not advance the RNG (the reference's `if sigma:`)."""
    rng = np.random.RandomState(0)
    before = rng.get_state()[1].copy()
    out = tc.apply_noise(np.full((5, 2), 0.6), 0.0, True, rng)
    np.testing.assert_array_equal(rng.get_state()[1], before)
    np.testing.assert_array_equal(out, 1.0)


@pytest.mark.parametrize("n", [1, 2, 9, 10, 2570, 2571])
def test_median_is_numpys(rng, n):
    """``torch.median`` returns the lower middle value; the study's median
    averages the two (every count of the study is even: 10 x 257)."""
    x = rng.randn(3, n).astype(F32) ** 2
    got = tc._median(torch.tensor(x), dim=1).numpy()
    np.testing.assert_array_equal(got, np.median(x, axis=1).astype(F32))
    np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=1)))
    np.testing.assert_array_equal(
        tc._median(torch.tensor(x.T.copy()), dim=0).numpy(), got)
    if n > 1:
        x[1, 0] = np.nan
        x[2, 0] = np.inf
        got = tc._median(torch.tensor(x), dim=1).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=1)))
        assert np.isnan(got[1])


def far_poses(traj, poses, offset=40.0):
    """Poses whose baseline is at least that of pose 12 of the study's 40
    on the same trajectory (below it the study is roundoff-chaotic)."""
    def baseline(sw, tw, an):
        c = -tc.StudyCamera.pose(offset, sw, tw, an)[:, :3].T @ \
            tc.StudyCamera.pose(offset, sw, tw, an)[:, 3]
        return np.linalg.norm(c - [0.0, 0.0, -offset])
    default = tc.make_trajectories(offset)[traj]
    b12 = baseline(default["sideways_values"][12],
                   default["towards_values"][12],
                   default["angle_values"][12])
    return np.array([baseline(sw, tw, an) >= b12 - 1e-9 for sw, tw, an in
                     zip(poses["sideways_values"], poses["towards_values"],
                         poses["angle_values"])])


def rel_err(a, b):
    """|a - b| / |b| where both are finite, else 0."""
    both = np.isfinite(a) & np.isfinite(b)
    a, b = np.where(both, a, 0.0), np.where(both, b, 0.0)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def hold_1and2(got, want, far, ls_flips=None):
    """``chip_smoke.py``'s rules for test 1 and 2.  got / want: dicts of
    [traj, pose, method] summaries (the per-point ones [traj, method,
    point]); far [traj, pose] bool.  ``ls_flips`` [traj, point]: points
    where one trial's linear-LS rank decision differs between the runs;
    their per-point statistics of that method are not held."""
    for k in ("err3D_mean", "err3D_median", "false_pos", "false_neg",
              "p_err3D_median"):
        np.testing.assert_array_equal(np.isfinite(got[k]),
                                      np.isfinite(want[k]), err_msg=k)
    bounds = dict(err3D_mean=1e-2, err3D_median=2e-2, err2D_mean=2e-2,
                  err2D_median=2e-2)
    for k, tol in bounds.items():
        r = rel_err(got[k], want[k])[far]
        assert r.max() <= tol, (k, r.max())
    for k in ("false_pos", "false_neg"):
        d = np.abs(got[k] - want[k])[far]
        assert d.max() <= 5e-3, (k, d.max())
    r = rel_err(got["p_err3D_median"], want["p_err3D_median"])
    if ls_flips is not None:
        r[:, 1] = np.where(ls_flips, 0.0, r[:, 1])
    assert r.max() <= 2e-2, ("p_err3D_median", r.max())


def linear_ls_flips(cam, P1, P2, points_h):
    """[N] bool: points where a trial's linear-LS solution at pose P2
    differs by > 1e-2 between the packages on the same normalized
    observations: the pseudo-inverse dropped an eigen-direction in one and
    kept it in the other (its |w| lies at rcond * |w|max)."""
    Z1, Z2 = tc._noise_basis(len(points_h))
    u = [np.round(cam.project_exact(points_h, P).astype(F32)[None]
                  + F32(0.8) * Z.astype(F32))
         for P, Z in ((P1, Z1), (P2, Z2))]
    un = [tc._normalize_obs(torch.tensor(x), cam.f, tuple(cam.c), cam.k1)
          for x in u]
    xt, _ = ttri.linear_ls(un[0], torch.tensor(P1, dtype=torch.float32),
                           un[1], torch.tensor(P2, dtype=torch.float32))
    xj, _ = jtri.linear_ls(jnp.asarray(un[0].numpy()), jnp.asarray(P1, F32),
                           jnp.asarray(un[1].numpy()), jnp.asarray(P2, F32))
    return (np.abs(xt.numpy() - np.asarray(xj)).max(-1) > 1e-2).any(0)


def test_eval_traj_summaries_against_jax():
    """Trajectory 4 (the circle to 90 degrees) at ``finite_points(3)``:
    poses 0, 3, 6, 9 and eight at index >= 12, the 90-degree end pose last
    (the per-point statistics are the last pose's)."""
    params = tc.StudyParams()
    pts = tc.finite_points(3)
    n = len(pts)
    idx = [0, 3, 6, 9, 12, 16, 20, 24, 28, 32, 36, 39]
    traj = tc.make_trajectories()[4]
    sel = {k: traj[k][idx] for k in ("sideways_values", "towards_values",
                                     "angle_values")}
    cam = tc.StudyCamera(params.cam_resolution, params.cam_k1)
    P1 = tc.StudyCamera.pose(40.0)
    P2s = [tc.StudyCamera.pose(40.0, sw, tw, an) for sw, tw, an in
           zip(sel["sideways_values"], sel["towards_values"],
               sel["angle_values"])]
    exact1 = cam.project_exact(pts, P1)
    exact2 = np.stack([cam.project_exact(pts, P) for P in P2s])
    Z1, Z2 = tc._noise_basis(n)
    args = [exact1, exact2, Z1, Z2, np.full(len(idx), 0.8), P1,
            np.stack(P2s)[:, None], pts[:, :3]]
    static = (cam.f, tuple(cam.c), cam.k1, True)
    got, inside = tc._eval_traj_summaries(
        *[torch.tensor(np.asarray(a, F32)) for a in args], *static)
    want, jinside = jtc._eval_traj_summaries_jit(
        *[jnp.asarray(a, F32) for a in args], *static)
    assert bool(inside) == bool(jinside)
    g = {k: np.stack([d[k].numpy() for d in got], -1)[None] for k in STATS}
    w = {k: np.stack([np.asarray(d[k]) for d in want], -1)[None]
         for k in STATS}
    for k in ("p_err3D_mean", "p_err3D_median", "p_err3Dv_mean",
              "p_err3Dv_covar"):
        g[k] = np.stack([d[k].numpy() for d in got])[None]
        w[k] = np.stack([np.asarray(d[k]) for d in want])[None]
        assert g[k].shape == w[k].shape
    far = far_poses(4, sel)[None]
    assert far.sum() == 8 and not far[0, :4].any()
    flips = linear_ls_flips(cam, P1, P2s[-1], pts)[None]
    assert flips.sum() <= 2          # 2 of 123 points (CPU, torch 2.13)
    hold_1and2(g, w, far, flips)


def load(path):
    return {k: v for k, v in sio.loadmat(path).items()
            if not k.startswith("__")}


def test_study_mat_files_against_jax(tmp_path):
    """``test_1and2`` / ``test_3`` through the module (``tc.test_1and2``)
    over 2 trajectories x 16 poses and 4 sigmas, at the radius-2 scene:
    the same variables and shapes as the JAX package's ``.mat`` files, and
    the values under ``hold_1and2`` / the test-3 rules."""
    params = tc.StudyParams(points_r=2)
    trajs = [tc.make_trajectories(num_poses=16)[i] for i in (0, 4)]
    jtrajs = [jtc.make_trajectories(num_poses=16)[i] for i in (0, 4)]
    kw = dict(params=params, verbose=False)
    tc.test_1and2(trajs, filename=str(tmp_path / "t12.mat"), device="cpu",
                  **kw)
    jtc.test_1and2(jtrajs, filename=str(tmp_path / "j12.mat"), **kw)
    tc.test_3(trajs, num_noise_tests=4, filename=str(tmp_path / "t3.mat"),
              device="cpu", **kw)
    jtc.test_3(jtrajs, num_noise_tests=4, filename=str(tmp_path / "j3.mat"),
               **kw)
    got12, want12 = load(tmp_path / "t12.mat"), load(tmp_path / "j12.mat")
    got3, want3 = load(tmp_path / "t3.mat"), load(tmp_path / "j3.mat")
    for got, want in ((got12, want12), (got3, want3)):
        assert got.keys() == want.keys()
        for k in want:
            assert np.shape(got[k]) == np.shape(want[k]), k
    for k in ("points_3D", "noise_sigma_values", "num_trials", "rseed"):
        np.testing.assert_array_equal(got3[k], want3[k])
    np.testing.assert_array_equal(got12["num_poses"], 16)
    far = np.stack([far_poses(i, t) for i, t in zip((0, 4), trajs)])
    strip = lambda d: {k[:-len("_summary")]: v for k, v in d.items()
                       if k.endswith("_summary")}
    cam = tc.StudyCamera(params.cam_resolution, params.cam_k1)
    P1 = tc.StudyCamera.pose(40.0)
    flips = np.stack([linear_ls_flips(cam, P1, tc.StudyCamera.pose(
        40.0, t["sideways_values"][-1], t["towards_values"][-1],
        t["angle_values"][-1]), tc.finite_points(2)) for t in trajs])
    assert flips.sum(1).max() <= 2   # 1 of 33 points (CPU, torch 2.13)
    hold_1and2(strip(got12), strip(want12), far, flips)
    # test 3: sigma index >= 1 (sigma = 0 is chaotic)
    g, w = strip(got3), strip(want3)
    r = rel_err(g["err3D_median"], w["err3D_median"])[:, :, 1:]
    assert r.max() <= 2e-2, r.max()
    for k in ("false_pos", "false_neg"):
        assert np.abs(g[k] - w[k])[:, :, 1:].max() <= 2e-2, k
