"""Synthetic BA scenario generator: the cube-orbit multi-robot example.

Pure-NumPy equivalent of the reference's GTSAM scenario generator
(reference: Work/SLAM/tools/bundle_adjustment/GenerateData.hpp:79-306):
8 landmarks on a 10 m cube, 1-2 robots orbiting at radius 40 / height +-10
facing the cube (the second offset 45 deg, mirrored), 20 frames, staged
landmark batches (4 init points with priors at step 0, the rest at step 1),
per-factor gaussian noise injection, per-camera odometry chains plus
cross-camera "stereo" between factors. Returns a BAData ready for
problem_from_ba_data — noise streams use numpy (statistical, not bitwise,
parity with the boost::random reference), so the same seed gives the JAX
package's scenario exactly.

``generate_corridor_problem`` builds the production-scale corridor problem
(thousands of poses, a landmark seen by a run of consecutive poses) directly
as a ``BAProblem``; it is host NumPy too, so every field equals the JAX
package's after the float32 cast.
"""

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.ba.problem import (BAProblem, BAVariables, _pad,
                                         _round_up, problem_to)
from mqslam_tpu_torch.io import ba_info

__all__ = ["generate_cube_scenario", "lookat_pose",
           "ground_truth_trajectories", "generate_corridor_problem"]


def lookat_pose(eye, target, up):
    """Cam-to-world pose (GTSAM Lookat convention: z forward, y down)."""
    eye = np.asarray(eye, float)
    zc = target - eye
    zc = zc / np.linalg.norm(zc)
    xc = np.cross(zc, np.asarray(up, float))
    xc = xc / np.linalg.norm(xc)
    yc = np.cross(zc, xc)
    W = np.eye(4)
    W[:3, 0], W[:3, 1], W[:3, 2], W[:3, 3] = xc, yc, zc, eye
    return W


def _project(W, cal, X):
    """Pixel projection of world points through cam-to-world pose W."""
    R = W[:3, :3]
    c = W[:3, 3]
    Xc = (X - c) @ R            # R^T (X - c)
    xn = Xc[:2] / Xc[2]
    fx, fy, s, u0, v0 = cal[:5]
    return np.array([fx * xn[0] + s * xn[1] + u0, fy * xn[1] + v0])


def _compose_noise(W, rvec, tvec):
    """W' = W * Pose(Exp(rvec), tvec) — GTSAM compose semantics."""
    from scipy.spatial.transform import Rotation
    D = np.eye(4)
    D[:3, :3] = Rotation.from_rotvec(rvec).as_matrix()
    D[:3, 3] = tvec
    return W @ D


def generate_cube_scenario(nr_cameras=1, nr_frames=20, seed=0,
                           noisy=True) -> ba_info.BAData:
    if nr_cameras not in (1, 2):
        raise ValueError("scenario supports 1 or 2 cameras")
    rng = np.random.RandomState(seed)
    S = nr_frames
    data = ba_info.BAData(nr_cameras=nr_cameras)

    for c in range(nr_cameras):
        data.pose_noise.append(ba_info.NoiseModel.diagonal(
            [0.02] * 3 + [0.1] * 3))
        data.point2D_noise.append(ba_info.NoiseModel.isotropic(2, 1.0))
        data.calibrations.append(np.array(
            [500.0, 500.0, 0.0, 320.0, 240.0, 0, 0, 0, 0]))
    data.odometry_noise = [[ba_info.NoiseModel.diagonal([0.05] * 3
                                                        + [0.2] * 3)
                            for _ in range(nr_cameras)]
                           for _ in range(nr_cameras)]
    data.point3D_noise = ba_info.NoiseModel.isotropic(3, 0.2)

    pts_true = np.array([[10, 10, 10], [-10, 10, 10], [-10, -10, 10],
                         [10, -10, 10], [10, 10, -10], [-10, 10, -10],
                         [-10, -10, -10], [10, -10, -10]], dtype=float)
    n_init = 4
    height, radius = 10.0, 40.0
    up = np.array([0.0, 0.0, 1.0])
    target = np.zeros(3)

    data.points2D = [[[] for _ in range(S)] for _ in range(nr_cameras)]
    data.point2D3D_assocs = [[] for _ in range(nr_cameras)]
    data.poses = [[] for _ in range(nr_cameras)]
    data.point3D_added_idxs = []
    data.odometry = []
    data.odometry_assocs = []

    W_true = [[None] * S for _ in range(nr_cameras)]
    for s in range(S):
        theta = s * 2 * np.pi / nr_frames
        data.point3D_added_idxs.append(
            list(range(n_init)) if s == 0 else
            (list(range(n_init, 8)) if s == 1 else []))
        for c in range(nr_cameras):
            if c == 0:
                pos = np.array([radius * np.cos(theta),
                                radius * np.sin(theta), height])
            else:
                pos = np.array([radius * np.cos(theta + np.pi / 4),
                                radius * np.sin(theta + np.pi / 4), -height])
            W = lookat_pose(pos, target, up)
            W_true[c][s] = W
            assocs = []
            if s == 0:
                obs_pts = range(n_init)
                obs_frame = 0
                extra = []
            else:
                extra = ([(p, s - 1, W_true[c][s - 1]) for p in
                          range(n_init, 8)] if s == 1 else [])
                obs_pts = range(8)
                obs_frame = s
            for (p, f, Wp) in extra:
                uv = _project(Wp, data.calibrations[c], pts_true[p])
                if noisy:
                    uv = uv + rng.normal(0, 1.0, 2)
                assocs.append((f, len(data.points2D[c][f]), p))
                data.points2D[c][f].append(uv)
            for p in obs_pts:
                uv = _project(W, data.calibrations[c], pts_true[p])
                if noisy:
                    uv = uv + rng.normal(0, 1.0, 2)
                assocs.append((obs_frame, len(data.points2D[c][obs_frame]),
                               p))
                data.points2D[c][obs_frame].append(uv)
            data.point2D3D_assocs[c].append(
                np.asarray(assocs, dtype=np.int64).reshape(-1, 3))

        # odometry
        odos, oassocs = [], []
        for c in range(nr_cameras):
            if s > 0:
                M = np.linalg.inv(W_true[c][s - 1]) @ W_true[c][s]
                if noisy:
                    M = _compose_noise(M, rng.normal(0, 0.05, 3),
                                       rng.normal(0, 0.2, 3))
                odos.append(M)
                oassocs.append((c, s - 1, c, s))
        if nr_cameras == 2:
            M = np.linalg.inv(W_true[0][s]) @ W_true[1][s]
            if noisy:
                M = _compose_noise(M, rng.normal(0, 0.05, 3),
                                   rng.normal(0, 0.2, 3))
            odos.append(M)
            oassocs.append((0, s, 1, s))
        data.odometry.append(odos)
        data.odometry_assocs.append(oassocs)

        # noisy poses (initial estimates)
        for c in range(nr_cameras):
            W = W_true[c][s]
            if noisy:
                W = _compose_noise(W, rng.normal(0, 0.02, 3),
                                   rng.normal(0, 0.1, 3))
            data.poses[c].append((W, 1.0 + s))

    # landmarks: init points exact, rest perturbed
    pts = pts_true.copy()
    if noisy:
        pts[n_init:] += rng.normal(0, 0.2, (8 - n_init, 3))
    data.points3D = pts
    data.point_colors = None
    # points2D lists -> arrays
    for c in range(nr_cameras):
        data.points2D[c] = [np.asarray(fr, dtype=np.float64).reshape(-1, 2)
                            for fr in data.points2D[c]]
    return data


def ground_truth_trajectories(nr_cameras=1, nr_frames=20):
    """Noise-free cam-to-world pose lists (for test assertions)."""
    data = generate_cube_scenario(nr_cameras, nr_frames, noisy=False)
    return [[W for (W, t) in data.poses[c]] for c in range(nr_cameras)]


def generate_corridor_problem(nr_frames=512, points_per_frame=24,
                              obs_window=8, seed=0, pad_multiple=128,
                              px_noise=0.6, point_noise=0.10,
                              pose_rot_noise=0.01, pose_t_noise=0.05,
                              device=None):
    """Production-scale synthetic BA problem built directly as a BAProblem
    on ``device`` (None: the CUDA device).

    A single camera sweeps a circular corridor looking along the tangent
    (0.4 m of arc a frame); each frame spawns ``points_per_frame``
    landmarks 2-8 m ahead inside its frustum, and each landmark is observed
    by the ``obs_window`` consecutive poses from its spawn frame on (the
    co-visibility structure of an exploratory SLAM trajectory); observations
    behind the camera or closer than 0.5 m are dropped.  The first pose and
    the first frame's landmarks carry priors at the truth.

    Returns (problem, v_true): the BAProblem with noisy initial values and
    the ground-truth variables."""
    from scipy.spatial.transform import Rotation

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    F = nr_frames
    P = F * points_per_frame
    # fixed 0.4 m arc step per frame: co-visibility (and hence the obs
    # survival rate of the behind-camera cull) is independent of F
    radius = F * 0.4 / (2 * np.pi)
    theta = np.arange(F) * (2 * np.pi / F)

    # cam-to-world: z = forward along the tangent, y = down
    eye = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                    np.zeros(F)], axis=1)
    zc = np.stack([-np.sin(theta), np.cos(theta), np.zeros(F)], axis=1)
    up = np.array([0.0, 0.0, -1.0])
    xc = np.cross(zc, np.broadcast_to(up, zc.shape))
    xc /= np.linalg.norm(xc, axis=1, keepdims=True)
    yc = np.cross(zc, xc)
    R_wc = np.stack([xc, yc, zc], axis=2)          # [F, 3, 3] columns

    cal = np.array([500.0, 500.0, 0.0, 320.0, 240.0, 0, 0, 0, 0])

    # landmarks: spawned in the spawning frame's frustum, depth 2-8 m
    spawn = np.repeat(np.arange(F), points_per_frame)          # [P]
    depth = rng.uniform(2.0, 8.0, P)
    u = rng.uniform(40.0, 600.0, P)
    v = rng.uniform(40.0, 440.0, P)
    xn = (u - cal[3]) / cal[0]
    yn = (v - cal[4]) / cal[1]
    dirs = np.stack([xn, yn, np.ones(P)], axis=1)              # cam coords
    X = (eye[spawn] + np.einsum("pij,pj->pi", R_wc[spawn],
                                dirs * depth[:, None]))        # [P, 3]

    # observations: poses spawn..spawn+obs_window-1 (wrap) see the landmark
    k = np.arange(obs_window)
    obs_pose = (spawn[:, None] + k[None, :]) % F               # [P, W]
    obs_point = np.broadcast_to(np.arange(P)[:, None], obs_pose.shape)
    obs_pose = obs_pose.reshape(-1)
    obs_point = obs_point.reshape(-1)
    # true projections + pixel noise
    d = X[obs_point] - eye[obs_pose]
    Xc = np.einsum("oij,oi->oj", R_wc[obs_pose], d)            # R^T d
    # drop observations behind the camera or at grazing depth (wrap seam)
    ok = Xc[:, 2] > 0.5
    obs_pose, obs_point, Xc = obs_pose[ok], obs_point[ok], Xc[ok]
    uv = np.stack([cal[0] * Xc[:, 0] / Xc[:, 2] + cal[3],
                   cal[1] * Xc[:, 1] / Xc[:, 2] + cal[4]], axis=1)
    uv += rng.normal(0, px_noise, uv.shape)
    n_obs = len(uv)

    # ground truth + noisy initial values
    rvec_true = Rotation.from_matrix(R_wc).as_rotvec()
    R_noisy = (Rotation.from_matrix(R_wc)
               * Rotation.from_rotvec(rng.normal(0, pose_rot_noise,
                                                 (F, 3)))).as_rotvec()
    t_noisy = eye + rng.normal(0, pose_t_noise, (F, 3))
    X_noisy = X + rng.normal(0, point_noise, (P, 3))
    # anchor: first pose + first frame's landmarks stay at truth
    R_noisy[0], t_noisy[0] = rvec_true[0], eye[0]

    # odometry chain from the noisy ground-truth motion (relative truth)
    odo_from = np.arange(F - 1)
    odo_to = odo_from + 1
    R_rel = np.einsum("fji,fjk->fik", R_wc[:-1], R_wc[1:])     # R_f^T R_t
    odo_r = Rotation.from_matrix(R_rel).as_rotvec()
    odo_t = np.einsum("fji,fj->fi", R_wc[:-1], eye[1:] - eye[:-1])

    O = _round_up(n_obs, pad_multiple)
    Q = _round_up(F - 1, pad_multiple)
    Rq = _round_up(points_per_frame, pad_multiple)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32))

    def valid(n_used, n):
        return torch.as_tensor(np.arange(n) < n_used)

    first_pts = np.arange(points_per_frame)
    prob = BAProblem(
        init=BAVariables(pose_r=f32(R_noisy), pose_t=f32(t_noisy),
                         points=f32(X_noisy)),
        pose_valid=torch.ones(F, dtype=torch.bool),
        point_valid=torch.ones(P, dtype=torch.bool),
        calibrations=f32(cal[None]),
        obs_uv=f32(_pad(uv, O)),
        obs_pose=i32(_pad(obs_pose, O)),
        obs_cam=torch.zeros(O, dtype=torch.int32),
        obs_point=i32(_pad(obs_point, O)),
        obs_sigma=torch.full((O,), 1.0),
        obs_valid=valid(n_obs, O),
        odo_r=f32(_pad(odo_r, Q)),
        odo_t=f32(_pad(odo_t, Q)),
        odo_from=i32(_pad(odo_from, Q)),
        odo_to=i32(_pad(odo_to, Q)),
        odo_sigma=f32(_pad(np.tile([0.05, 0.05, 0.05, 0.2, 0.2, 0.2],
                                   (F - 1, 1)), Q, fill=1.0)),
        odo_valid=valid(F - 1, Q),
        prior_pose_idx=torch.zeros(1, dtype=torch.int32),
        prior_pose_r=f32(rvec_true[:1]),
        prior_pose_t=f32(eye[:1]),
        prior_pose_sigma=f32([[0.02, 0.02, 0.02, 0.1, 0.1, 0.1]]),
        prior_pose_valid=torch.ones(1, dtype=torch.bool),
        prior_point_idx=i32(_pad(first_pts, Rq)),
        prior_point_xyz=f32(_pad(X[first_pts], Rq)),
        prior_point_sigma=torch.full((Rq,), 0.2),
        prior_point_valid=valid(points_per_frame, Rq),
    )
    v_true = BAVariables(pose_r=f32(rvec_true), pose_t=f32(eye),
                         points=f32(X))
    return (problem_to(prob, device),
            BAVariables(*(x.to(device) for x in v_true)))
