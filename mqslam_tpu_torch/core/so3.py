"""SO(3): rotation-vector <-> rotation-matrix (Rodrigues), batched."""

import torch

from mqslam_tpu_torch.core import quat as _quat
from mqslam_tpu_torch.core.smallmat import matmul_small

__all__ = ["hat", "exp", "log", "rvec_from_matrix", "matrix_from_rvec",
           "delta_rvec"]

_EPS = 1e-12


def hat(v):
    """Skew-symmetric matrix [v]_x of vector(s) [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def exp(rvec):
    """Rodrigues: rotation vector [..., 3] -> rotation matrix [..., 3, 3].

    Taylor-safe near zero angle (guarded sinc-style coefficients)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-10
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    K = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * K + b[..., None, None] * matmul_small(K, K)


def log(R):
    """Inverse Rodrigues: rotation matrix -> rotation vector (angle in
    [0, pi]), routed through the quaternion double cover for stability near
    0 and pi."""
    return _quat.to_rvec(_quat.from_matrix(R))


# Aliases with the domain-specific names used around the codebase.
matrix_from_rvec = exp
rvec_from_matrix = log


def delta_rvec(r1, r2):
    """Rotation vector of the relative rotation taking r1 to r2:
    exp(out) = exp(r2) exp(r1)^-1."""
    return _quat.to_rvec(_quat.delta(_quat.from_rvec(r1), _quat.from_rvec(r2)))
