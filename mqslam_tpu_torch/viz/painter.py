"""Composite 2D/3D debug painters — headless PNG output.

The reference's in-app debug views (reference: Work/SLAM/application/own/
slam2.py:78-135 Composite2DPainter — current frame + axis system +
triangulated dots colored by group + depth labels + to-be-triangulated
crosses + red border on rejected frames; :137-286 Composite3DPainter —
virtual camera over the map: colored landmarks, camera trajectory line,
frustum of the current camera and keyframes, pan/zoom/rotate navigation)
re-done headless: ``draw`` composes a numpy RGB image, ``save`` writes a
PNG. The 3D painter keeps the reference's navigation semantics as
methods (move/zoom/rotate mutate the view pose P) instead of key
bindings.
"""

import numpy as np
import torch

from mqslam_tpu_torch.core import se3
from mqslam_tpu_torch.viz import draw as dw
from mqslam_tpu_torch.viz.colors import color_palette

__all__ = ["Composite2DPainter", "Composite3DPainter", "save_png"]


def _pose_matrix(rvec, tvec):
    """4x4 world->cam of (rvec, tvec) in float32 on the CPU, as NumPy."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).reshape(3)
    return se3.from_rvec_tvec(f32(rvec), f32(tvec)).numpy()


def save_png(path, img):
    """Write an [H, W(, 3)] uint8 image as PNG (PIL backend)."""
    from PIL import Image
    Image.fromarray(np.asarray(img)).save(path)


def _put_text(img, text, org, color):
    """Tiny text via PIL's built-in bitmap font (depth labels etc.)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    d.text((float(org[0]), float(org[1])), text,
           fill=tuple(int(c) for c in color))
    img[:, :, :] = np.asarray(im)
    return img


class Composite2DPainter:
    """Current-frame overlay (slam2.py:78-135)."""

    def __init__(self, image_size):
        self.image_size = image_size
        w, h = image_size
        self.img = np.zeros((h, w, 3), np.uint8)
        self.palette, self.palette_size = color_palette(2, 3, 4)

    def draw(self, img, rvec, tvec, status, K, dist, uv, alive,
             triangulated, objp_idx, objp, objp_groups, group_id,
             depth_labels: bool = True):
        """status: 0 bad frame, 1 tracked, 2 keyframe (slam2.py:93-99).

        uv/alive/triangulated/objp_idx are the tracker's fixed-capacity
        slot arrays; objp/objp_groups the landmark store.
        """
        self.img[:, :, :] = dw._ensure_rgb(img)
        uv = np.asarray(uv)
        alive = np.asarray(alive)
        if status:
            dw.draw_axis_system(self.img, K, dist, rvec, tvec)
            tri = alive & np.asarray(triangulated)
            idxs = np.asarray(objp_idx)
            P = _pose_matrix(rvec, tvec)
            pts = np.asarray(objp)[idxs]
            depth = pts @ P[2, :3] + P[2, 3]
            groups = np.asarray(objp_groups)[idxs]
            colors = self.palette[groups % self.palette_size]
            for s in np.flatnonzero(tri):
                dw.circle(self.img, uv[s], 2, colors[s], thickness=-1)
                if depth_labels:
                    _put_text(self.img, f"{depth[s]:.3f}",
                              uv[s] + np.array([-15, 10]), colors[s])
            # to-be-triangulated points as crosses in the current group
            # color (slam2.py:122-127)
            col = self.palette[int(group_id) % self.palette_size]
            for s in np.flatnonzero(alive & ~np.asarray(triangulated)):
                dw.cross(self.img, uv[s], 2, col)
        else:
            # red border: bad frame (slam2.py:129-133)
            w, h = self.image_size
            box = [((0, 0), (w - 1, 0)), ((w - 1, 0), (w - 1, h - 1)),
                   ((w - 1, h - 1), (0, h - 1)), ((0, h - 1), (0, 0))]
            for p1, p2 in box:
                dw.line(self.img, p1, p2, dw.rgb(255, 0, 0), thickness=4)
        return self.img

    def save(self, path):
        save_png(path, self.img)


class Composite3DPainter:
    """Virtual top-view of the map + trajectory (slam2.py:137-286)."""

    def __init__(self, P_view, image_size):
        self.P = np.asarray(P_view, np.float64)
        self.image_size = image_size
        w, h = image_size
        self.img = np.zeros((h, w, 3), np.uint8)
        self.K = np.eye(3)
        self.K[0, 0] = self.K[1, 1] = min(image_size)
        self.K[0, 2] = w / 2.0
        self.K[1, 2] = h / 2.0
        self.cams_pos = np.empty((0, 3))
        self.cams_pos_keyfr = np.empty((0, 3))
        self.palette, self.palette_size = color_palette(2, 3, 4)
        self.color_mode = 0  # 0: landmark intensity, 1: group colors

    # --- navigation (the reference's key bindings, slam2.py:139-150) ---
    def _translate(self, d):
        self.P[:3, 3] += np.asarray(d, np.float64)

    def move_left(self, step=1.0):
        self._translate([step, 0, 0])

    def move_right(self, step=1.0):
        self._translate([-step, 0, 0])

    def move_up(self, step=1.0):
        self._translate([0, step, 0])

    def move_down(self, step=1.0):
        self._translate([0, -step, 0])

    def zoom_in(self, step=1.0):
        self._translate([0, 0, -step])

    def zoom_out(self, step=1.0):
        self._translate([0, 0, step])

    def rotate_z(self, angle):
        c, s = np.cos(angle), np.sin(angle)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        self.P[:3, :] = Rz @ self.P[:3, :]

    def switch_colors(self):
        self.color_mode = 1 - self.color_mode

    def draw(self, rvec, tvec, status, points3d, point_colors,
             point_groups, triangulated_mask=None, neg_fy=False):
        """Render landmarks + cached trajectory + current camera."""
        self.img[:, :, :] = 0
        pts = np.asarray(points3d, np.float64)
        H, W = self.img.shape[:2]
        if len(pts):
            proj = np.concatenate([pts, np.ones((len(pts), 1))], 1) \
                @ self.P[:3, :].T @ self.K.T
            z = proj[:, 2]
            uv = proj[:, :2] / np.where(np.abs(z[:, None]) > 1e-12,
                                        z[:, None], 1e-12)
            ok = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W) \
                & (uv[:, 1] >= 0) & (uv[:, 1] < H)
            xi = np.rint(uv[ok, 0]).astype(int)
            yi = np.rint(uv[ok, 1]).astype(int)
            if self.color_mode == 0:
                g = np.clip(np.asarray(point_colors)[ok], 0,
                            255).astype(np.uint8)
                cols = np.stack([g, g, g], axis=1)
            else:
                cols = self.palette[np.asarray(point_groups)[ok]
                                    % self.palette_size]
            self.img[yi, xi] = cols

        if status:
            P_cam = _pose_matrix(rvec, tvec).astype(np.float64)
            R = P_cam[:3, :3]
            center = -R.T @ P_cam[:3, 3]
            self.cams_pos = np.vstack([self.cams_pos, center])
            if status == 2:
                self.cams_pos_keyfr = np.vstack([self.cams_pos_keyfr,
                                                 center])
            # trajectory polyline (slam2.py:200-212 role)
            if len(self.cams_pos) > 1:
                traj = np.concatenate(
                    [self.cams_pos, np.ones((len(self.cams_pos), 1))], 1) \
                    @ self.P[:3, :].T @ self.K.T
                zt = traj[:, 2]
                uvt = traj[:, :2] / np.where(np.abs(zt[:, None]) > 1e-12,
                                             zt[:, None], 1e-12)
                okt = zt > 0
                for i in range(len(uvt) - 1):
                    if okt[i] and okt[i + 1]:
                        dw.line(self.img, uvt[i], uvt[i + 1],
                                dw.rgb(80, 80, 255))
            dw.draw_camera(self.img, center[None, :], R, self.K, self.P,
                           neg_fy=neg_fy)
        return self.img

    def save(self, path):
        save_png(path, self.img)
