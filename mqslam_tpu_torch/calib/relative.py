"""Multi-camera relative-pose calibration.

Library form of the reference's per-camera-chessboard workflow
(reference: Work/calibration/application/calibrate.py:602-657
calibrate_relative_poses_interactive): each camera observes its own board
(with known board-to-world transform), absolute poses come from PnP per
image, poses are averaged across images weighted by inverse reprojection
error, and everything is rebased to camera 0. The reference averages raw
4x4 matrices (calibrate.py:653-655); that behavior is kept, with an
SO(3)-projected variant beside it.
"""

from typing import Sequence

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import camera as cam_mod, se3, so3
from mqslam_tpu_torch.ops import pnp

__all__ = ["calibrate_relative_poses"]


def _pose_matrix(rvec, tvec):
    """4x4 world->cam matrix of float32 (rvec, tvec), as NumPy."""
    return se3.from_rvec_tvec(rvec.to(torch.float32),
                              tvec.to(torch.float32)).cpu().numpy()


def calibrate_relative_poses(image_points: Sequence[Sequence[np.ndarray]],
                             board_objps: Sequence[np.ndarray],
                             cals: Sequence[cam_mod.Cal3DS2],
                             project_to_se3: bool = False, device=None):
    """Relative extrinsics of N cameras from per-image board detections.

    image_points[cam][img]: [K, 2] detected corners of camera `cam`'s board
    in image `img`; board_objps[cam]: [K, 3] corresponding world points
    (already board-to-world transformed, calibrate.py:619-625);
    cals[cam]: intrinsics.  The PnP runs on ``device`` (None: the CUDA
    device), one image and camera at a time.

    Returns (relative_Ps, worst_reproj_error): relative_Ps[cam] maps
    cam0-frame to cam-frame (P_cam @ P_cam0^-1, identity for cam 0)."""
    device = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    cals = [c.to(device) for c in cals]
    num_cams = len(image_points)
    num_images = len(image_points[0])
    Ps = np.zeros((num_images, num_cams, 4, 4))
    weights = np.zeros((num_images, 1, 1, 1))
    worst = 0.0

    for i in range(num_images):
        reproj = 0.0
        for c in range(num_cams):
            uv = f32(image_points[c][i])
            objp = f32(board_objps[c])
            uvn = cam_mod.undistort_points(uv, cals[c])
            R, t = pnp.pnp_solve(objp, uvn)
            rvec = so3.log(R)
            rvec, tvec = pnp.pnp_refine(objp, uv, cals[c], rvec, t, iters=10)
            rms, _ = pnp.reprojection_error(objp, uv, cals[c], rvec, tvec)
            reproj = max(float(rms), reproj)
            Ps[i, c] = _pose_matrix(rvec, tvec)
        worst = max(worst, reproj)
        weights[i] = 1.0 / max(reproj, 1e-12)

    # reference behavior: weighted average of raw 4x4 pose matrices
    # (calibrate.py:653-655), then rebase to camera 0
    Ps_avg = (Ps * (weights / weights.sum())).sum(axis=0)
    if project_to_se3:
        for c in range(num_cams):
            R = Ps_avg[c, :3, :3]
            U, _, Vt = np.linalg.svd(R)
            S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
            Ps_avg[c, :3, :3] = U @ S @ Vt
            Ps_avg[c, 3] = [0, 0, 0, 1]
    # the reference rebases with its rigid-inverse helper (calibrate.py:656
    # trfm.P_inv) although the averaged matrix is not rigid; the exact
    # matrix inverse makes rel[0] identically I
    P0_inv = np.linalg.inv(Ps_avg[0])
    rel = [Ps_avg[c] @ P0_inv for c in range(num_cams)]
    return rel, worst
