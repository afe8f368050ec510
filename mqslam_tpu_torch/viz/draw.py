"""2D drawing primitives + camera/axis overlays (pure numpy rasterization).

The reference's OpenCV drawing helpers re-implemented dependency-free
(reference: Work/python_libs/cv2_helpers.py — thin wrappers :19-37,
drawKeypointsAndMotion :43, drawAxisSystem :54-86, drawCamera :89-150,
wireframe3DGeometry :222-240). Images are [H, W, 3] uint8 RGB numpy
arrays; all rasterizers are vectorized numpy (host-side debug path, not
device code); the one projection runs the package's camera model on float32
CPU tensors.  PNG IO + text go through viz.painter.
"""

import numpy as np
import torch

from mqslam_tpu_torch.core import camera as cam_mod, se3

__all__ = ["rgb", "line", "lines", "circle", "cross", "fill_poly",
           "draw_keypoints_and_motion", "draw_axis_system", "draw_camera",
           "wireframe_3d_geometry"]


def rgb(r, g, b):
    """Color tuple helper (cv2_helpers.py uses BGR; we are RGB-native)."""
    return np.array([r, g, b], np.uint8)


def _plot(img, xs, ys, color, thickness=1):
    """Set pixels (with square brush of ``thickness``) at xs/ys (int)."""
    H, W = img.shape[:2]
    t = max(int(thickness), 1)
    offs = np.arange(-(t // 2), (t + 1) // 2)
    dx, dy = np.meshgrid(offs, offs)
    xs = (xs[:, None] + dx.reshape(-1)[None, :]).reshape(-1)
    ys = (ys[:, None] + dy.reshape(-1)[None, :]).reshape(-1)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color
    return img


def line(img, p0, p1, color, thickness=1):
    """Rasterize one segment by dense parameter sampling."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(np.ceil(np.abs(p1 - p0).max())) + 1
    ts = np.linspace(0.0, 1.0, max(n, 2))
    pts = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
    xy = np.rint(pts).astype(int)
    return _plot(img, xy[:, 0], xy[:, 1], color, thickness)


def lines(img, p0s, p1s, color, thickness=1):
    for a, b in zip(np.asarray(p0s), np.asarray(p1s)):
        line(img, a, b, color, thickness)
    return img


def circle(img, center, radius, color, thickness=1):
    """Circle outline; thickness=-1 fills (cv2 convention)."""
    cx, cy = float(center[0]), float(center[1])
    r = float(radius)
    if thickness == -1:
        ys, xs = np.mgrid[int(cy - r):int(cy + r) + 2,
                          int(cx - r):int(cx + r) + 2]
        m = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
        return _plot(img, xs[m].reshape(-1), ys[m].reshape(-1), color)
    n = max(int(2 * np.pi * r) * 2, 8)
    th = np.linspace(0, 2 * np.pi, n)
    xs = np.rint(cx + r * np.cos(th)).astype(int)
    ys = np.rint(cy + r * np.sin(th)).astype(int)
    return _plot(img, xs, ys, color, thickness)


def cross(img, p, size, color):
    """The to-be-triangulated marker (slam2.py:124-127)."""
    x, y = int(round(float(p[0]))), int(round(float(p[1])))
    line(img, (x - size, y), (x + size, y), color)
    line(img, (x, y - size), (x, y + size), color)
    return img


def fill_poly(img, pts, color):
    """Filled convex polygon by half-plane test over the bounding box."""
    pts = np.asarray(pts, np.float64)
    x0, y0 = np.floor(pts.min(0)).astype(int)
    x1, y1 = np.ceil(pts.max(0)).astype(int)
    H, W = img.shape[:2]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, W - 1), min(y1, H - 1)
    if x1 < x0 or y1 < y0:
        return img
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = np.ones(xs.shape, bool)
    n = len(pts)
    # consistent orientation
    a01 = pts[1] - pts[0]
    a02 = pts[2 % n] - pts[0]
    area = a01[0] * a02[1] - a01[1] * a02[0]
    sign = 1.0 if area >= 0 else -1.0
    for i in range(n):
        a, b = pts[i], pts[(i + 1) % n]
        inside &= sign * ((b[0] - a[0]) * (ys - a[1])
                          - (b[1] - a[1]) * (xs - a[0])) >= 0
    img[ys[inside], xs[inside]] = color
    return img


def draw_keypoints_and_motion(img2, points1, points2, color,
                              point_color=(255, 0, 0), radius=3):
    """New image: keypoints on img2 + motion vectors points1 -> points2
    (cv2_helpers.py:43-51)."""
    img = _ensure_rgb(img2).copy()
    for p1, p2 in zip(np.asarray(points1), np.asarray(points2)):
        line(img, p1, p2, np.asarray(color, np.uint8))
    for p in np.asarray(points2):
        circle(img, p, radius, np.asarray(point_color, np.uint8))
    return img


def _ensure_rgb(img):
    img = np.asarray(img)
    if img.ndim == 2:
        g = np.clip(img, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _project(objp, rvec, tvec, K, dist):
    """Pixels and depths of objp [N, 3] under (rvec, tvec), K and dist,
    in float32 on the CPU (host drawing, like the JAX package's)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    cal = cam_mod.cal_from_K_dist(f32(K), None if dist is None else f32(dist))
    P = se3.from_rvec_tvec(f32(rvec).reshape(3), f32(tvec).reshape(3))
    uv, z = cam_mod.project(f32(objp), P, cal)
    return uv.numpy(), z.numpy()


def draw_axis_system(img, K, dist, rvec, tvec, scale=4.0):
    """World axis system overlay (cv2_helpers.py:54-86): X red, Y green,
    Z blue, filled black origin with white ring. Skipped when the origin
    projects outside the image."""
    objp = scale * np.array([[0., 0., 0.], [1., 0., 0.],
                             [0., 1., 0.], [0., 0., 1.]])
    uv, _ = _project(objp, rvec, tvec, K, dist)
    origin, x_ax, y_ax, z_ax = np.rint(uv).astype(int)
    H, W = img.shape[:2]
    if not (0 <= origin[0] < W and 0 <= origin[1] < H):
        return img
    line(img, origin, x_ax, rgb(255, 0, 0), thickness=2)
    line(img, origin, y_ax, rgb(0, 255, 0), thickness=2)
    line(img, origin, z_ax, rgb(0, 0, 255), thickness=2)
    circle(img, origin, 4, rgb(0, 0, 0), thickness=-1)
    circle(img, origin, 5, rgb(255, 255, 255), thickness=2)
    return img


def wireframe_3d_geometry():
    """Unit-box + axis wireframe (verts [N,3], edges [E,2]) — the shape
    catalog role of cv2_helpers.py:222-240."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                     np.float64)
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0],
                      [4, 5], [5, 6], [6, 7], [7, 4],
                      [0, 4], [1, 5], [2, 6], [3, 7]], np.int32)
    return verts, edges


def draw_camera(img, cam_origin, cam_axes, K, P, neg_fy=False,
                scale_factor=0.07, draw_axes=True, draw_frustum=True):
    """Draw a camera (origin + axes + frustum + up-triangle) into a view
    with intrinsics K and extrinsics P (cv2_helpers.py:89-150 semantics,
    including the constant-apparent-size normalization and the neg_fy
    Y-flip)."""
    objp = np.array([[0., 0., 0.],
                     [1., 0., 0.], [0., 1., 0.], [0., 0., 1.],
                     [-0.5, -0.3, 1.], [0.5, -0.3, 1.],
                     [0.5, 0.3, 1.], [-0.5, 0.3, 1.],
                     [-0.3, -0.3, 1.], [0.3, -0.3, 1.], [0., -0.6, 1.]])
    P = np.asarray(P, np.float64)
    cam_origin = np.asarray(cam_origin, np.float64).reshape(3)
    depth_norm = np.linalg.norm(cam_origin + P[:3, :3].T @ P[:3, 3])
    objp = objp * (depth_norm * scale_factor)
    if neg_fy:
        objp[:, 1] *= -1
    objp = cam_origin[None, :] + objp @ np.asarray(cam_axes, np.float64)

    H, W = img.shape[:2]
    Kn = np.asarray(K, np.float64)
    proj = np.concatenate([objp, np.ones((len(objp), 1))], 1) @ P[:3, :].T
    proj = proj @ Kn.T
    vis = proj[:, 2] > 0
    uv = proj[:, :2] / np.where(np.abs(proj[:, 2:3]) > 1e-12,
                                proj[:, 2:3], 1e-12)
    vis &= (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (
        uv[:, 1] < H)
    if not vis.all():
        return img
    o = uv[0]
    if draw_axes:
        line(img, o, uv[1], rgb(255, 0, 0))
        line(img, o, uv[2], rgb(0, 255, 0))
        line(img, o, uv[3], rgb(0, 0, 255))
        circle(img, uv[3], 3, rgb(0, 0, 255))
    if draw_frustum:
        yellow = rgb(255, 255, 0)
        for i in range(4):
            line(img, uv[4 + i], uv[4 + (i + 1) % 4], yellow)
            line(img, o, uv[4 + i], yellow)
        fill_poly(img, uv[8:11], yellow)
    return img
