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
package's scenario exactly.  The JAX package's production-scale corridor
generator is not ported yet (ROADMAP Queue 1 item 11).
"""

import numpy as np

from mqslam_tpu_torch.io import ba_info

__all__ = ["generate_cube_scenario", "lookat_pose",
           "ground_truth_trajectories"]


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
