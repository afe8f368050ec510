"""Image-level undistortion with optimal new camera matrix + ROI crop.

Replicates the reference's ``undistort_image``
(calibration_tools.py:59-86: cv2.getOptimalNewCameraMatrix(alpha=1) ->
initUndistortRectifyMap -> remap -> ROI crop) as one batched device remap:
the dst->src coordinate map is closed-form (newK^-1 -> distort -> K), so
there is no stored map pair.
"""

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import camera as cam_mod
from mqslam_tpu_torch.ops import lk

__all__ = ["get_optimal_new_camera_matrix", "undistort_image"]


def _rectangles(cal: cam_mod.Cal3DS2, image_size, n: int = 9):
    """Inner/outer rectangles of the undistorted image border in normalized
    coordinates (cv2 icvGetRectangles: an n x n grid over the image is
    undistorted; outer = bounding box, inner = the largest axis-aligned
    rectangle guaranteed inside the distorted border).  Computed on the
    calibration's device in float32."""
    w, h = image_size
    xs = np.linspace(0, w - 1, n)
    ys = np.linspace(0, h - 1, n)
    gx, gy = np.meshgrid(xs, ys)
    uv = torch.as_tensor(np.stack([gx, gy], -1).reshape(-1, 2)
                         .astype(np.float32)).to(cal.fx.device)
    pn = cam_mod.undistort_points(uv, cal).cpu().numpy().reshape(n, n, 2)
    ox0, oy0 = pn[..., 0].min(), pn[..., 1].min()
    ox1, oy1 = pn[..., 0].max(), pn[..., 1].max()
    ix0 = pn[:, 0, 0].max()    # left edge
    ix1 = pn[:, -1, 0].min()   # right edge
    iy0 = pn[0, :, 1].max()    # top edge
    iy1 = pn[-1, :, 1].min()   # bottom edge
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def get_optimal_new_camera_matrix(cal: cam_mod.Cal3DS2, image_size,
                                  alpha: float = 1.0, new_size=None):
    """New intrinsic matrix + valid-pixel ROI, cv2.getOptimalNewCameraMatrix
    semantics: alpha=0 -> every output pixel is valid (zoom to the inner
    rectangle), alpha=1 -> every source pixel retained (outer rectangle).

    Returns (K_new [3,3] float64, roi (x, y, w, h) ints).

    Negative fy: the normalized-coordinate rectangles flip sign in y; the
    blended scale keeps the sign so the output image keeps the source's
    row order."""
    w, h = image_size
    nw, nh = new_size if new_size is not None else (w, h)
    inner, outer = _rectangles(cal, image_size)
    flip_y = float(cal.fy) < 0

    def norm_rect(rect):
        # with fy < 0 the inner rectangle comes out with negative height
        # (normalized y decreases down the image); the outer one is a plain
        # min/max bounding box and is already positive
        x0, y0, rw, rh = rect
        return (x0, y0 + rh, rw, -rh) if rh < 0 else rect

    inner = norm_rect(inner)
    outer = norm_rect(outer)

    def k_of(rect):
        x0, y0, rw, rh = rect
        fx = (nw - 1) / rw
        fy = (nh - 1) / rh
        return fx, fy, -fx * x0, -fy * y0

    fx0, fy0, cx0, cy0 = k_of(inner)
    fx1, fy1, cx1, cy1 = k_of(outer)
    a = float(alpha)
    fx = fx0 * (1 - a) + fx1 * a
    fy = fy0 * (1 - a) + fy1 * a
    cx = cx0 * (1 - a) + cx1 * a
    cy = cy0 * (1 - a) + cy1 * a
    if flip_y:
        fy, cy = -fy, (nh - 1) - cy
    K_new = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    # valid-pixel ROI: the inner rectangle through the new K
    ix0, iy0, iw, ih = inner
    rx0 = int(np.ceil(ix0 * fx + cx))
    ry0 = int(np.ceil(iy0 * fy + cy)) if not flip_y else int(
        np.ceil((iy0 + ih) * fy + cy))
    rw = int(np.floor(iw * abs(fx)))
    rh = int(np.floor(ih * abs(fy)))
    rx0 = max(rx0, 0)
    ry0 = max(ry0, 0)
    rw = min(rw, nw - rx0)
    rh = min(rh, nh - ry0)
    return K_new, (rx0, ry0, rw, rh)


def undistort_image(img, cal: cam_mod.Cal3DS2, image_size=None,
                    alpha: float = 1.0, crop: bool = True, device=None):
    """Undistort an image; returns (undistorted image as NumPy, roi).

    calibration_tools.py:59-86 semantics: with the default alpha=1 all
    source pixels are retained and ``roi`` marks (and, with crop=True,
    cuts) the always-valid region.  img is [H, W] or [H, W, C] (any float
    or uint8 range); uint8 comes back rounded half to even (np.rint).  The
    remap runs on ``device`` (None: the CUDA device)."""
    device = resolve_device(device)
    cal = cal.to(device)
    img = np.asarray(img)
    H, W = img.shape[:2]
    if image_size is None:
        image_size = (W, H)
    K_new, roi = get_optimal_new_camera_matrix(cal, image_size, alpha)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    out = _remap(f32(img), cal.as_array().to(torch.float32),
                 f32(K_new)).cpu().numpy()
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    if crop:
        x, y, w, h = roi
        out = out[y:y + h, x:x + w]
    return out, roi


def _remap(img, cal_arr, K_new):
    """dst -> src bilinear remap: dst pixel -> normalized (K_new^-1) ->
    distort -> src pixel (K), over [H, W] or [H, W, C] (channels in one
    batched gather)."""
    cal = cam_mod.Cal3DS2.from_array(cal_arr)
    H, W = img.shape[0], img.shape[1]
    u, v = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=img.device),
        torch.arange(H, dtype=torch.float32, device=img.device),
        indexing="xy")
    xn = (u - K_new[0, 2]) / K_new[0, 0]
    yn = (v - K_new[1, 2]) / K_new[1, 1]
    src = cam_mod.denormalize_points(
        cam_mod.distort_normalized(torch.stack([xn, yn], dim=-1), cal), cal)
    src = src.reshape(H * W, 2)
    if img.ndim == 2:
        return lk.bilinear_sample(img, src).reshape(H, W)
    chans = img.permute(2, 0, 1)                              # [C, H, W]
    out = lk.bilinear_sample(chans, src.expand((chans.shape[0],) + src.shape))
    return out.reshape(-1, H, W).permute(1, 2, 0)
