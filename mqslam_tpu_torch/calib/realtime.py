"""Frame-at-a-time chessboard pose estimation (the realtime-pose loop).

The reference's option-8 webcam loop (reference: Work/calibration/
application/calibrate.py:506-599 realtime_pose_estimation: per frame —
find chessboard -> solvePnP -> draw axis system -> optional keyframe
snapshot to .jpg + .txt) without the capture window: feed frames from any
source; get back the pose, an axis-overlay debug image, and snapshot
helpers writing the same artifacts.
"""

import os

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.calib.zhang import grid_objp
from mqslam_tpu_torch.core import camera as cam_mod, so3
from mqslam_tpu_torch.ops import chessboard as cb, pnp
from mqslam_tpu_torch.viz import draw as dw

__all__ = ["pose_from_chessboard_frame", "save_pose_snapshot"]


def pose_from_chessboard_frame(img, board_size, K, dist=None,
                               square_size: float = 1.0, overlay=True,
                               device=None):
    """One iteration of the realtime loop, on ``device`` (None: the CUDA
    device).

    img [H, W] grayscale. Returns (ok, rvec, tvec, overlay_img) —
    overlay_img is the RGB frame with the world axis system drawn at the
    board origin (calibrate.py:549-556), or None when not requested or the
    board is not found."""
    device = resolve_device(device)
    found, corners = cb.find_chessboard_corners(img, board_size,
                                                device=device)
    if not found:
        return False, None, None, None
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    objp = f32(grid_objp(board_size, scale=square_size))
    cal = cam_mod.cal_from_K_dist(f32(K), None if dist is None else f32(dist))
    uv = f32(corners)
    uvn = cam_mod.undistort_points(uv, cal)
    R, t = pnp.pnp_solve(objp, uvn)
    rvec, tvec = pnp.pnp_refine(objp, uv, cal, so3.log(R), t, iters=10)
    rvec = rvec.cpu().numpy()
    tvec = tvec.cpu().numpy()
    out = None
    if overlay:
        out = dw._ensure_rgb(img).copy()
        dw.draw_axis_system(out, np.asarray(K), dist, rvec, tvec,
                            scale=2.0 * square_size)
    return True, rvec, tvec, out


def save_pose_snapshot(out_dir, idx, img, rvec, tvec):
    """Keyframe snapshot: image + pose text, the SPACE-key behavior of the
    reference loop (calibrate.py:573-586 writes .jpg + .txt pairs)."""
    from mqslam_tpu_torch.viz.painter import save_png

    os.makedirs(out_dir, exist_ok=True)
    img_path = os.path.join(out_dir, f"keyframe_{idx:04d}.png")
    txt_path = os.path.join(out_dir, f"keyframe_{idx:04d}.txt")
    save_png(img_path, dw._ensure_rgb(img))
    with open(txt_path, "w") as f:
        f.write("# rvec tvec (world->cam)\n")
        f.write(" ".join(f"{v:.9g}" for v in np.asarray(rvec).reshape(-1))
                + "\n")
        f.write(" ".join(f"{v:.9g}" for v in np.asarray(tvec).reshape(-1))
                + "\n")
    return img_path, txt_path
