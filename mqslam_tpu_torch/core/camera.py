"""Camera models: pinhole intrinsics + radial/tangential distortion (Cal3DS2).

9-parameter wire order ``fx fy s u0 v0 k1 k2 p1 p2``.  Negative ``fy``
(mirrored renders) is supported throughout — normalization divides by the
signed focal length.

All functions broadcast over leading batch dims.  Where a pose ``P`` meets a
point set, P's batch dims must broadcast against the points' batch dims: for
``P [A, 4, 4]`` and ``points [A, K, 3]`` pass ``P[:, None]``.
"""

from typing import NamedTuple

import torch

from mqslam_tpu_torch.core import smallmat

__all__ = [
    "Cal3DS2", "K_from_cal", "cal_from_K_dist", "normalize_points", "denormalize_points",
    "distort_normalized", "undistort_normalized", "undistort_points",
    "project", "project_normalized", "projection_depth",
]


class Cal3DS2(NamedTuple):
    """9-parameter calibration: pinhole (fx, fy, skew, u0, v0) + distortion
    (k1, k2 radial; p1, p2 tangential)."""
    fx: torch.Tensor
    fy: torch.Tensor
    s: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @classmethod
    def from_array(cls, a):
        return cls(*(a[..., i] for i in range(9)))

    def as_array(self):
        return torch.stack(tuple(self), dim=-1)

    def to(self, device):
        return Cal3DS2(*(x.to(device) for x in self))


def K_from_cal(cal: Cal3DS2):
    """3x3 intrinsic matrix from a Cal3DS2."""
    z = torch.zeros_like(cal.fx)
    o = torch.ones_like(cal.fx)
    K = torch.stack([cal.fx, cal.s, cal.u0,
                     z, cal.fy, cal.v0,
                     z, z, o], dim=-1)
    return K.reshape(K.shape[:-1] + (3, 3))


def cal_from_K_dist(K, dist=None):
    """Cal3DS2 from a 3x3 K and OpenCV distortion coeffs (k1,k2,p1,p2[,k3]).

    k3 (if present) is dropped — the Cal3DS2 model has no 6th-order radial
    term."""
    if dist is None:
        dist = torch.zeros(K.shape[:-2] + (4,), dtype=K.dtype,
                           device=K.device)
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    return Cal3DS2(K[..., 0, 0], K[..., 1, 1], K[..., 0, 1],
                   K[..., 0, 2], K[..., 1, 2], k1, k2, p1, p2)


def normalize_points(uv, cal: Cal3DS2):
    """Pixel -> normalized image coordinates (inverts K, not distortion)."""
    y = (uv[..., 1] - cal.v0) / cal.fy
    x = (uv[..., 0] - cal.u0 - cal.s * y) / cal.fx
    return torch.stack([x, y], dim=-1)


def denormalize_points(xn, cal: Cal3DS2):
    """Normalized image coordinates -> pixels (applies K)."""
    u = cal.fx * xn[..., 0] + cal.s * xn[..., 1] + cal.u0
    v = cal.fy * xn[..., 1] + cal.v0
    return torch.stack([u, v], dim=-1)


def distort_normalized(xn, cal: Cal3DS2):
    """Apply the DS2 distortion model to normalized coords [..., 2].

    x' = x (1 + k1 r^2 + k2 r^4) + 2 p1 x y + p2 (r^2 + 2 x^2)
    y' = y (1 + k1 r^2 + k2 r^4) + p1 (r^2 + 2 y^2) + 2 p2 x y
    """
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cal.k1 + r2 * cal.k2)
    xd = x * radial + 2.0 * cal.p1 * x * y + cal.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cal.p1 * (r2 + 2.0 * y * y) + 2.0 * cal.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xd, cal: Cal3DS2, iters: int = 8):
    """Invert the distortion by ``iters`` fixed-point steps:
    x_{i+1} = (x_d - tangential(x_i)) / radial(x_i)."""
    x = xd
    for _ in range(iters):
        xi, yi = x[..., 0], x[..., 1]
        r2 = xi * xi + yi * yi
        radial = 1.0 + r2 * (cal.k1 + r2 * cal.k2)
        dx = 2.0 * cal.p1 * xi * yi + cal.p2 * (r2 + 2.0 * xi * xi)
        dy = cal.p1 * (r2 + 2.0 * yi * yi) + 2.0 * cal.p2 * xi * yi
        x = torch.stack([(xd[..., 0] - dx) / radial,
                         (xd[..., 1] - dy) / radial], dim=-1)
    return x


def undistort_points(uv, cal: Cal3DS2, iters: int = 8):
    """Pixels -> undistorted normalized coordinates."""
    return undistort_normalized(normalize_points(uv, cal), cal, iters)


def project_normalized(points, P):
    """World points [..., 3] through extrinsic P -> (normalized xy, depth)."""
    pc = smallmat.matvec_small(P[..., :3, :3], points) + P[..., :3, 3]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    return pc[..., :2] / zs[..., None], z


def project(points, P, cal: Cal3DS2):
    """Full projection world -> pixels with distortion; returns (uv, depth).

    Points behind the camera still produce finite pixels (the caller filters
    on the returned depth)."""
    xn, z = project_normalized(points, P)
    return denormalize_points(distort_normalized(xn, cal), cal), z


def projection_depth(points, P):
    """Signed depth of world points in the camera frame."""
    R = P[..., :3, :3]
    t = P[..., :3, 3]
    return (R[..., 2, :] * points).sum(-1) + t[..., 2]
