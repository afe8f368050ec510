"""SE(3) rigid transforms as 4x4 homogeneous matrices, batched.

The extrinsic matrix ``P`` maps world points to camera coordinates:
``x_cam = P @ [x_world, 1]``.  A TUM pose row stores the camera centre and
the camera-to-world quaternion, i.e. the *inverse* of P.
"""

import torch

from mqslam_tpu_torch.core import quat as _quat, so3 as _so3
from mqslam_tpu_torch.core.smallmat import matmul_small, matvec_small

__all__ = ["identity", "from_R_t", "from_rvec_tvec", "to_rvec_tvec", "inv",
           "compose", "delta", "apply", "from_pose_tum", "to_pose_tum"]


def identity(dtype=torch.float32, device=None):
    """The 4x4 identity, made on ``device``."""
    return torch.eye(4, dtype=dtype, device=device)


def from_R_t(R, t):
    """4x4 P from rotation [..., 3, 3] and translation [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # (0, 0, 0, 1) made on the device: a host list would be a copy that
    # waits for the stream, and no CUDA graph can capture it
    bottom = identity(top.dtype, top.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_rvec_tvec(rvec, tvec):
    """4x4 P from (rvec, tvec) as produced by PnP."""
    return from_R_t(_so3.exp(rvec), tvec)


def to_rvec_tvec(P):
    """(rvec, tvec) from 4x4 P."""
    return _so3.log(P[..., :3, :3]), P[..., :3, 3]


def inv(P):
    """Closed-form rigid inverse: [R t]^-1 = [R^T, -R^T t]."""
    R = P[..., :3, :3]
    t = P[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_R_t(Rt, -matvec_small(Rt, t))


def compose(P2, P1):
    """P2 after P1 (matrix product in exact float32)."""
    return matmul_small(P2, P1)


def delta(P1, P2):
    """Relative transform taking the frame of P1 to that of P2:
    P2 @ P1^-1 (the odometry factor's measurement)."""
    return matmul_small(P2, inv(P1))


def apply(P, pts):
    """Apply P to 3D point(s) [..., 3]; P's batch dims must broadcast
    against the points' (insert a point axis: ``P[..., None, :, :]``)."""
    return matvec_small(P[..., :3, :3], pts) + P[..., :3, 3]


def from_pose_tum(q, center):
    """Extrinsic P from a TUM pose (quat xyzw [..., 4], camera centre
    [..., 3]): TUM stores camera-to-world, so R = R(q)^T, t = -R c."""
    R = _quat.to_matrix(_quat.normalize(q)).transpose(-1, -2)
    return from_R_t(R, -matvec_small(R, center))


def to_pose_tum(P):
    """(quat xyzw, camera centre) of the TUM pose for extrinsic P."""
    Pi = inv(P)
    return _quat.from_matrix(Pi[..., :3, :3]), Pi[..., :3, 3]
