"""SVO synthetic dataset adapter: initialization + ground-truth repair.

Equivalents of the reference's init tooling (reference:
Work/SLAM/datasets/SVO/svo_initialization.py — bisection search on the
corner quality level until exactly N features are detected :36-47, then
closed-form back-projection of those features onto the known z-plane
:62-85 — and svo_reparation.py:23-28 quaternion normalization).
"""

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.io import tum

__all__ = ["initialize_from_plane", "normalize_groundtruth"]


def initialize_from_plane(img, P0, cal, target_features=100, plane_z=0.0,
                          cell=12, bisect_iters=24, device=None):
    """Detect ~``target_features`` corners in frame 0 and back-project them
    onto the z=``plane_z`` world plane for metric bootstrap.

    Bisection over the quality level reproduces svo_initialization.py:36-47's
    exact-count search (one host read of the count a round); the count is
    matched as closely as the detector's quality quantization allows, then
    truncated to the target.  The detector runs on ``device`` (None: the
    card), the undistortion on ``cal``'s device; the ray/plane intersection
    stays on the host in float64.
    Returns NumPy (uv [N, 2], objp [N, 3]), float32.
    """
    from mqslam_tpu_torch.core import camera as cam_mod
    from mqslam_tpu_torch.ops import features

    device = resolve_device(device)
    img_t = torch.as_tensor(np.asarray(img, dtype=np.float32)).to(device)
    lo, hi = 1e-6, 0.5
    best = None
    for _ in range(bisect_iters):
        q = 0.5 * (lo + hi)
        uv, valid = features.detect_corners(
            img_t, max_corners=4 * target_features, quality_level=q,
            cell=cell)
        n = int(valid.sum())
        if best is None or abs(n - target_features) < abs(best[0]
                                                         - target_features):
            best = (n, uv[valid].cpu().numpy())
        if n > target_features:
            lo = q
        elif n < target_features:
            hi = q
        else:
            break
    uv = best[1][:target_features]

    # closed-form ray/plane intersection in the world frame
    xn = cam_mod.undistort_points(
        torch.as_tensor(uv, dtype=torch.float32).to(cal.fx.device),
        cal).cpu().numpy()
    d_cam = np.concatenate([xn, np.ones((len(xn), 1))], axis=1)
    R = np.asarray(P0)[:3, :3]
    t = np.asarray(P0)[:3, 3]
    center = -R.T @ t
    d_world = d_cam @ R
    s = (plane_z - center[2]) / d_world[:, 2]
    objp = center[None] + s[:, None] * d_world
    return uv.astype(np.float32), objp.astype(np.float32)


def normalize_groundtruth(traj: "tum.CamTrajectory") -> "tum.CamTrajectory":
    """Quaternion-normalize a ground-truth trajectory
    (svo_reparation.py:23-28; load_trajectory already normalizes, this is the
    explicit file-repair entry)."""
    q = np.asarray(traj.quaternions, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return tum.CamTrajectory(np.asarray(traj.timestamps),
                             np.asarray(traj.locations), q)
