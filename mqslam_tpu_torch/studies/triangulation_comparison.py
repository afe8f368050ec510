"""Synthetic triangulation-method comparison study.

Replicates the reference study (reference: Work/triangulation_comparison/
triangulation_comparison.py) — 4 triangulation methods x 5 second-camera
trajectories x noise models, with the same scene (grid points in a radius-4
sphere at offset 40), the same camera model (f = min(resolution), principal
point at center, k1 barrel distortion :91-113), the same noise process
(gaussian sigma=0.8 px + discretization, :149-162), the same fixed seed
(123456789, :370) and the same summary statistics (:205-260) — saved to .mat
files with the same variable names so the reference's Octave visualizers run
unchanged.

Batched instead of the reference's 32 000 sequential solver calls
(:436-468): ONE device call of shape [poses, trials, N] per trajectory.
Because the reference resets its RNG seed before each pose's trials, the
standard-normal noise basis is identical across poses / trajectories /
sigmas, so only exact projections + that small basis go to the device
(bit-identical to the reference's NumPy draws), observations are
synthesized there (u = rint(exact + sigma Z), float32), and all summary
statistics reduce there; only [poses, methods] summaries and the last
pose's per-point statistics come back.

    python -m mqslam_tpu_torch.studies.triangulation_comparison \
        --out-dir DIR [--skip-test3] [--device cuda|cpu]
"""

import math
import os
from dataclasses import dataclass
from time import time
from typing import Tuple

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import camera as cam_mod
from mqslam_tpu_torch.ops import triangulation as tri
from mqslam_tpu_torch.utils.profiling import sync

__all__ = [
    "StudyParams", "StudyCamera", "finite_points", "infinite_points",
    "make_trajectories", "test_1and2", "test_3", "main",
]

NUM_TRIALS = 10
RSEED = 123456789
ROBUSTNESS_THRESH_MAX = 1.0 ** 2   # triangulation_comparison.py:373-374
ROBUSTNESS_THRESH_MIN = 1.0 ** 2
METHOD_NAMES = ["linear_eigen_triangulation", "linear_LS_triangulation",
                "iterative_LS_triangulation", "polynomial_triangulation"]
METHODS = [tri.METHODS[k] for k in ("linear_eigen", "linear_ls",
                                    "iterative_ls", "polynomial")]


@dataclass
class StudyParams:
    """default_params of the reference (:266-287)."""
    points_source: str = "finite"
    points_r: int = 4
    points_max_angle: float = math.pi / 4
    points_x_on: bool = True
    points_y_on: bool = True
    points_z_on: bool = True
    cam_resolution: Tuple[int, int] = (640, 480)
    cam_k1: float = 0.3
    cam_pose_offset: float = 40.0
    cam_noise_sigma: float = 0.8
    cam_noise_discretized: bool = True
    cam1_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cam2_pose: Tuple[float, float, float] = (5.0, 0.0, 0.0)


def finite_points(r, x_on=True, y_on=True, z_on=True):
    """Integer grid points inside a radius-r sphere, homogeneous [P, 4]
    (:21-33)."""
    rx, ry, rz = r * x_on, r * y_on, r * z_on
    pts = [(x, y, z, 1.0)
           for x in range(-rx, rx + 1)
           for y in range(-ry, ry + 1)
           for z in range(-rz, rz + 1)
           if x * x + y * y + z * z <= r * r]
    return np.array(pts, dtype=np.float64)


def infinite_points(r, max_angle, x_on=True, y_on=True):
    """Directions (w=0) on an XY disc pushed to infinite +Z (:35-49)."""
    rx, ry = r * x_on, r * y_on
    z = r / math.tan(max_angle)
    pts = [(x, y, z, 0.0)
           for x in range(-rx, rx + 1)
           for y in range(-ry, ry + 1)
           if x * x + y * y <= r * r]
    return np.array(pts, dtype=np.float64)


class StudyCamera:
    """The study's camera: f = min(resolution), centered principal point,
    k1-only barrel distortion; pose parameterized by (offset, sideways,
    towards, angle) (:91-123)."""

    def __init__(self, resolution=(640, 480), k1=0.0):
        self.set_intrinsics(resolution, k1)

    def set_intrinsics(self, resolution, k1):
        self.f = float(min(resolution))
        self.c = np.array(resolution, dtype=np.float64) / 2.0
        self.k1 = float(k1)
        self.resolution = resolution
        self.cal = cam_mod.Cal3DS2.from_array(torch.tensor(
            [self.f, self.f, 0.0, self.c[0], self.c[1],
             self.k1, 0.0, 0.0, 0.0], dtype=torch.float32))

    @staticmethod
    def pose(offset, sideways=0.0, towards=0.0, angle=0.0):
        """3x4 P: camera starts at (0,0,-offset) looking along +Z, translated
        by (sideways, 0, towards), rotated by `angle` around Y (:109-123)."""
        sa, ca = math.sin(angle), math.cos(angle)
        R = np.array([[ca, 0.0, sa], [0.0, 1.0, 0.0], [-sa, 0.0, ca]])
        center = np.array([sideways, 0.0, -offset + towards])
        t = -R @ center
        return np.concatenate([R, t[:, None]], axis=1)

    def project_exact(self, points_h, P):
        """Project homogeneous [N,4] points (w=0 supported) to pixels with
        distortion — NumPy float64, matching the reference's
        cv2.projectPoints path (:127-147)."""
        pc = points_h @ P.T  # [N, 3]
        xn = pc[:, :2] / pc[:, 2:3]
        x, y = xn[:, 0], xn[:, 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2
        xd = np.stack([x * radial, y * radial], axis=1)
        return xd * self.f + self.c


def apply_noise(points_2D_exact, sigma, discretized, rng):
    """The reference noise process (:149-162): additive gaussian (skipped
    entirely when sigma == 0 — rng must not advance), optional rint."""
    if sigma:
        pts = points_2D_exact + rng.normal(0, sigma, points_2D_exact.shape)
    else:
        pts = points_2D_exact
    if discretized:
        pts = np.rint(pts)
    return pts


def make_trajectories(offset=40.0, num_poses=40, max_sideways=12.0,
                      max_towards=12.0):
    """The five second-camera trajectories (:383-401)."""

    def traj(descr, from_sideways=0.0, to_sideways=0.0, from_towards=0.0,
             to_towards=0.0, from_angle=0.0, to_angle=0.0,
             angle_by_sideways=False):
        if angle_by_sideways:
            from_angle = math.asin(from_sideways / offset)
            to_angle = math.asin(to_sideways / offset)
            angles = np.linspace(from_angle, to_angle, num_poses)
            sideways = offset * np.sin(angles)
            towards = offset * (1 - np.cos(angles))
        else:
            sideways = np.linspace(from_sideways, to_sideways, num_poses)
            towards = np.linspace(from_towards, to_towards, num_poses)
            angles = np.linspace(from_angle, to_angle, num_poses)
        return {"traj_descr": descr, "sideways_values": sideways,
                "towards_values": towards, "angle_values": angles}

    return [
        traj("From 1st cam, to sideways", to_sideways=max_sideways),
        traj("From 1st cam, towards the sphere of points",
             to_towards=max_towards),
        traj("From last pose of trajectory 1, towards the sphere of points, "
             "parallel to trajectory 2", from_sideways=max_sideways,
             to_sideways=max_sideways, to_towards=max_towards),
        traj("From 1st cam, describing circle (while facing the sphere of "
             "points) until intersecting with trajectory 3",
             to_sideways=max_sideways, angle_by_sideways=True),
        traj("From last pose of trajectory 4, describing circle (while "
             "facing the sphere of points) until 90 degrees",
             from_sideways=max_sideways, to_sideways=offset,
             angle_by_sideways=True),
    ]


# ---------------------------------------------------------------------------
# Device-side batched evaluation (float32 tensors)
#
# The reference resets the RNG seed before every pose's trials (:447-453) and
# every sigma's trials (:575-581), and numpy's normal(0, sigma) is
# sigma * standard_normal from the same stream — so the *standard-normal
# noise basis* (Z1[t], Z2[t]) is identical across poses, trajectories and
# sigma values.

def _normalize_obs(u, f, c, k1):
    """Pixels -> normalized coords; shortcut division when k1 == 0, 10
    iterations of undistortion otherwise (:164-173 semantics)."""
    if k1 == 0.0:
        return (u - torch.tensor(c, dtype=u.dtype, device=u.device)) / f
    cal = cam_mod.Cal3DS2.from_array(torch.tensor(
        [f, f, 0.0, c[0], c[1], k1, 0.0, 0.0, 0.0], dtype=u.dtype,
        device=u.device))
    return cam_mod.undistort_points(u, cal, iters=10)


def _project_px(x, P, f, c, k1):
    """Project inhomogeneous 3D points through 3x4 P with k1 distortion
    (for the 2D reprojection error); P's batch dims cover poses, an axis is
    added so they broadcast over the trailing point dimension of x."""
    Px = P[..., None, :3, :]  # [..., 1, 3, 4]
    pc = (Px[..., :3] * x[..., None, :]).sum(-1) + Px[..., 3]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-30, z, torch.full_like(z, 1e-30))
    xn = pc[..., :2] / zs[..., None]
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    xd = xn * (1.0 + k1 * r2)
    return xd * f + torch.tensor(c, dtype=x.dtype, device=x.device)


def _median(x, dim=-1):
    """``jnp.median`` / ``np.median``: the mean of the two middle values of
    an even count (``torch.median`` returns the lower one), NaN where the
    slice holds a NaN."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    mid = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(dim=dim),
                       torch.full_like(mid, float("nan")), mid)


def _sq_err(v):
    return torch.sum(v.float() ** 2, dim=-1)


def _summaries_one_method(x, status, points_xyz, P1, P2, exact1, exact2,
                          f, c, k1):
    """Per-pose summary statistics for one method's batched solutions.

    x [poses, T, N, 3], status [poses, T, N]; P2/exact2 carry the pose batch.
    Returns dict of [poses]-shaped tensors + last-pose per-point stats.
    """
    err3d = x - points_xyz
    e3 = _sq_err(err3d)                          # [poses, T, N]
    e1 = _sq_err(_project_px(x, P1, f, c, k1) - exact1)
    e2 = _sq_err(_project_px(x, P2, f, c, k1) - exact2)
    e12 = torch.cat([e1, e2], dim=-1)            # [poses, T, 2N]
    B = e3.shape[0]
    flat3 = e3.reshape(B, -1)
    flat12 = e12.reshape(B, -1)
    pos_est = (status > 0).reshape(B, -1)
    fp = ((flat3 > ROBUSTNESS_THRESH_MAX) & pos_est).float().mean(dim=1)
    fn = ((flat3 <= ROBUSTNESS_THRESH_MIN) & ~pos_est).float().mean(dim=1)
    last = err3d[-1]                             # [T, N, 3]
    sq_last = e3[-1]                             # [T, N]
    mean_v = torch.mean(last, dim=0)             # [N, 3]
    dev = last - mean_v[None]
    covar = torch.sum(dev[..., :, None] * dev[..., None, :],
                      dim=0) / last.shape[0]     # [N, 3, 3]
    return {
        "err3D_mean": torch.sqrt(torch.mean(flat3, dim=1)),
        "err3D_median": torch.sqrt(_median(flat3, dim=1)),
        "err2D_mean": torch.sqrt(torch.mean(flat12, dim=1)),
        "err2D_median": torch.sqrt(_median(flat12, dim=1)),
        "false_pos": fp,
        "false_neg": fn,
        "p_err3D_mean": torch.sqrt(torch.mean(sq_last, dim=0)),
        "p_err3D_median": torch.sqrt(_median(sq_last, dim=0)),
        "p_err3Dv_mean": mean_v,
        "p_err3Dv_covar": covar,
    }


def _eval_traj_summaries(exact1, exact2, Z1, Z2, sigmas, P1, P2,
                         points_xyz, f, c, k1, discretized):
    """Device pipeline: synthesize noisy pixels for every (pose-or-sigma,
    trial), normalize, run all 4 methods, reduce to per-pose summaries.

    Tensors on one device: exact1 [N, 2]; exact2 [B, N, 2]; Z [T, N, 2];
    sigmas [B] (0.8 broadcast for test_1and2, the sweep for test_3); P2
    [B, 1, 3, 4] or [1, 1, 3, 4]; all float32.  Returns (one dict a method,
    inside: a bool tensor).
    """
    dt = torch.float32
    s = sigmas[:, None, None, None].to(dt)
    u1 = exact1[None, None].to(dt) + s * Z1[None].to(dt)
    u2 = exact2[:, None].to(dt) + s * Z2[None].to(dt)
    if discretized:
        u1 = torch.round(u1)
        u2 = torch.round(u2)
    inside = torch.all((u2[..., 0] >= 0) & (u2[..., 0] < 2 * c[0])
                       & (u2[..., 1] >= 0) & (u2[..., 1] < 2 * c[1]))
    u1n = _normalize_obs(u1, f, c, k1)
    u2n = _normalize_obs(u2, f, c, k1)
    out = []
    for fn_ in METHODS:
        x, status = fn_(u1n, P1, u2n, P2)
        out.append(_summaries_one_method(
            x, status, points_xyz, P1, P2, exact1.to(dt),
            exact2[:, None].to(dt), f, c, k1))
    return tuple(out), inside


_timer_total = 0.0


def _timed(fn, *args):
    """Call ``fn`` and add its seconds to ``_timer_total``, the card's work
    included (synchronized before the clock is read)."""
    global _timer_total
    t0 = time()
    out = sync(fn(*args))
    _timer_total += time() - t0
    return out


def _to_host(summ):
    return {k: v.cpu().numpy() for k, v in summ.items()}


def _noise_basis(n_points):
    """Standard-normal draws in the reference's order: per trial, cam1 block
    then cam2 block. Returns Z1, Z2 [NUM_TRIALS, n, 2] (float64)."""
    rng = np.random.RandomState(RSEED)
    Z1 = np.empty((NUM_TRIALS, n_points, 2))
    Z2 = np.empty((NUM_TRIALS, n_points, 2))
    for t in range(NUM_TRIALS):
        Z1[t] = rng.normal(0.0, 1.0, (n_points, 2))
        Z2[t] = rng.normal(0.0, 1.0, (n_points, 2))
    return Z1, Z2


def _observations_for_poses(cam1, cam2, P1, P2s, points_h, sigma,
                            discretized):
    """Exact projections + per-(pose, trial) noisy observations, drawn in the
    reference's order: seed reset per pose, then cam1 noise, cam2 noise per
    trial (:447-453)."""
    exact1 = cam1.project_exact(points_h, P1)
    n = len(points_h)
    u1 = np.empty((len(P2s), NUM_TRIALS, n, 2))
    u2 = np.empty((len(P2s), NUM_TRIALS, n, 2))
    inside = True
    for pi, P2 in enumerate(P2s):
        exact2 = cam2.project_exact(points_h, P2)
        rng = np.random.RandomState(RSEED)
        for t in range(NUM_TRIALS):
            u1[pi, t] = apply_noise(exact1, sigma, discretized, rng)
            u2[pi, t] = apply_noise(exact2, sigma, discretized, rng)
            w, h = cam2.resolution
            inside &= bool(np.all((0 <= u2[pi, t, :, 0])
                                  & (u2[pi, t, :, 0] < w)
                                  & (0 <= u2[pi, t, :, 1])
                                  & (u2[pi, t, :, 1] < h)))
    return u1, u2, inside


def test_1and2(trajectories=None, filename="test_1and2.mat",
               params=None, dtype=torch.float32, verbose=True, device=None):
    """Tests 1 & 2: error vs camera configuration and vs point position
    (:403-515). One batched device call per trajectory on ``device``
    (None: the card)."""
    import scipy.io as sio

    device = resolve_device(device)
    params = params or StudyParams()
    trajectories = trajectories or make_trajectories(params.cam_pose_offset)
    points_h = (finite_points(params.points_r, params.points_x_on,
                              params.points_y_on, params.points_z_on)
                if params.points_source == "finite" else
                infinite_points(params.points_r, params.points_max_angle,
                                params.points_x_on, params.points_y_on))
    n_pts = len(points_h)
    num_poses = len(trajectories[0]["sideways_values"])
    n_traj = len(trajectories)
    n_meth = len(METHODS)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    cam1 = StudyCamera(params.cam_resolution, params.cam_k1)
    cam2 = StudyCamera(params.cam_resolution, params.cam_k1)
    P1 = StudyCamera.pose(params.cam_pose_offset, *params.cam1_pose)

    shapes = (n_traj, num_poses, n_meth)
    summary = {k: np.zeros(shapes) for k in
               ["err3D_mean", "err3D_median", "err2D_mean", "err2D_median",
                "false_pos", "false_neg"]}
    summary["p_err3D_mean"] = np.zeros((n_traj, n_meth, n_pts))
    summary["p_err3D_median"] = np.zeros((n_traj, n_meth, n_pts))
    summary["p_err3Dv_mean"] = np.zeros((n_traj, n_meth, n_pts, 3))
    summary["p_err3Dv_covar"] = np.zeros((n_traj, n_meth, n_pts, 3, 3))

    inf_mask = points_h[:, 3] == 0.0
    points_xyz = dev(np.where(inf_mask[:, None], 0.0, points_h[:, :3]))
    Z1, Z2 = _noise_basis(n_pts)
    Z1t, Z2t = dev(Z1), dev(Z2)
    sigmas = torch.full((num_poses,), params.cam_noise_sigma, dtype=dtype,
                        device=device)
    exact1 = dev(cam1.project_exact(points_h, P1))
    P1t = dev(P1)
    is_inside = True

    for ti_traj, traj in enumerate(trajectories):
        if verbose:
            print(f"Performing trajectory id {ti_traj} ...")
        P2s = [StudyCamera.pose(params.cam_pose_offset, sw, tw, an)
               for sw, tw, an in zip(traj["sideways_values"],
                                     traj["towards_values"],
                                     traj["angle_values"])]
        exact2 = dev(np.stack([cam2.project_exact(points_h, P2)
                               for P2 in P2s]))
        P2t = dev(np.stack(P2s))[:, None]  # [poses, 1, 3, 4]
        results, inside = _timed(
            _eval_traj_summaries, exact1, exact2, Z1t, Z2t, sigmas, P1t, P2t,
            points_xyz, cam1.f, tuple(cam1.c), cam1.k1,
            params.cam_noise_discretized)
        is_inside &= bool(inside)

        for mi, summ in enumerate(results):
            summ = _to_host(summ)
            for k in ("err3D_mean", "err3D_median", "err2D_mean",
                      "err2D_median", "false_pos", "false_neg"):
                summary[k][ti_traj, :, mi] = summ[k]
            for k in ("p_err3D_mean", "p_err3D_median", "p_err3Dv_mean",
                      "p_err3Dv_covar"):
                summary[k][ti_traj, mi] = summ[k]

    if not is_inside:
        print("Warning: some points fell out of view.")

    variables = {k + "_summary": v for k, v in summary.items()}
    variables.update({
        "units": ["trajectory id", "node in a trajectory",
                  "triangulation method", "point index"],
        "trajectories": trajectories,
        "triangl_methods": METHOD_NAMES,
        "points_3D": points_h,
        "robustness_thresh_max": ROBUSTNESS_THRESH_MAX,
        "robustness_thresh_min": ROBUSTNESS_THRESH_MIN,
        "num_trials": NUM_TRIALS,
        "rseed": RSEED,
        "num_poses": num_poses,
    })
    if filename:
        sio.savemat(filename, variables)
    return variables


def test_3(trajectories=None, max_noise_sigma=4.0, num_noise_tests=40,
           filename="test_3.mat", params=None, dtype=torch.float32,
           verbose=True, device=None):
    """Test 3: error vs noise model, at the last pose of each trajectory
    (:517-627). Three noise types: gaussian; +discretization; +distortion.
    One batched device call per (trajectory, noise type)."""
    import scipy.io as sio

    device = resolve_device(device)
    params = params or StudyParams()
    trajectories = trajectories or make_trajectories(params.cam_pose_offset)
    points_h = finite_points(params.points_r, params.points_x_on,
                             params.points_y_on, params.points_z_on)
    inf_mask = points_h[:, 3] == 0.0
    n_meth = len(METHODS)
    num_noise_types = 3
    shapes = (len(trajectories), num_noise_types, num_noise_tests, n_meth)
    keys = ["err3D_mean", "err3D_median", "err2D_mean", "err2D_median",
            "false_pos", "false_neg"]
    sums = {k: np.zeros(shapes) for k in keys}
    noise_sigmas = np.linspace(0, max_noise_sigma, num_noise_tests)
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    cam1 = StudyCamera(params.cam_resolution, 0.0)
    cam2 = StudyCamera(params.cam_resolution, 0.0)
    P1 = StudyCamera.pose(params.cam_pose_offset, *params.cam1_pose)
    P1t = dev(P1)
    points_xyz = dev(np.where(inf_mask[:, None], 0.0, points_h[:, :3]))
    Z1, Z2 = _noise_basis(len(points_h))
    Z1t, Z2t = dev(Z1), dev(Z2)
    sigmas_t = dev(noise_sigmas)
    is_inside = True

    for ti_traj, traj in enumerate(trajectories):
        P2 = StudyCamera.pose(params.cam_pose_offset,
                              traj["sideways_values"][-1],
                              traj["towards_values"][-1],
                              traj["angle_values"][-1])
        P2t = dev(P2)[None, None]
        for ntyi in range(num_noise_types):
            if verbose:
                print(f"Performing trajectory {ti_traj} noise type {ntyi} ...")
            discretized = ntyi >= 1
            k1 = params.cam_k1 if ntyi == 2 else 0.0
            cam1.set_intrinsics(params.cam_resolution, k1)
            cam2.set_intrinsics(params.cam_resolution, k1)
            exact1 = dev(cam1.project_exact(points_h, P1))
            exact2 = dev(cam2.project_exact(points_h, P2))[None].expand(
                (num_noise_tests, len(points_h), 2))
            results, inside = _timed(
                _eval_traj_summaries, exact1, exact2, Z1t, Z2t, sigmas_t,
                P1t, P2t, points_xyz, cam1.f, tuple(cam1.c), k1, discretized)
            is_inside &= bool(inside)
            for mi, summ in enumerate(results):
                for k in keys:
                    sums[k][ti_traj, ntyi, :, mi] = summ[k].cpu().numpy()

    if not is_inside:
        print("Warning: some points fell out of view.")

    variables = {k + "_summary": sums[k] for k in keys}
    variables.update({
        "units": ["id of last pose's trajectory", "noise type id",
                  "noise sigma id", "triangulation method"],
        "trajectories": trajectories,
        "noise_type_descr": [
            "Add. gauss. noise", "Add. gauss. noise + discret.",
            "Add. gauss. noise + discret. + rad. distort. (barrel)"],
        "noise_sigma_values": noise_sigmas,
        "triangl_methods": METHOD_NAMES,
        "points_3D": points_h,
        "robustness_thresh_max": ROBUSTNESS_THRESH_MAX,
        "robustness_thresh_min": ROBUSTNESS_THRESH_MIN,
        "num_trials": NUM_TRIALS,
        "rseed": RSEED,
        "num_noise_tests": num_noise_tests,
        "max_noise_sigma": max_noise_sigma,
    })
    if filename:
        sio.savemat(filename, variables)
    return variables


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--skip-test3", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA device)")
    args = ap.parse_args(argv)
    print("Running tests 1 and 2 ...")
    test_1and2(filename=os.path.join(args.out_dir, "test_1and2.mat"),
               device=args.device)
    if not args.skip_test3:
        print("Running test 3 ...")
        test_3(filename=os.path.join(args.out_dir, "test_3.mat"),
               device=args.device)
    print(f"device triangulation+eval time: {_timer_total:.3f} s")


if __name__ == "__main__":
    main()
