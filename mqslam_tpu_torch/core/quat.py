"""Quaternion algebra, batched over leading dims.

Convention: quaternions are stored as ``(x, y, z, w)`` — the TUM trajectory
convention — in tensors of shape ``[..., 4]``.  Only what ``so3`` / ``se3``
need is here (the remaining helpers of the JAX package's module follow with
the modules that use them).
"""

import torch

__all__ = ["identity", "normalize", "to_rvec", "from_matrix"]

_EPS = 1e-12


def identity(dtype=torch.float32, device=None):
    """The identity rotation quaternion (0, 0, 0, 1)."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def normalize(q):
    """Normalize to unit length (safe at ~zero norm: returns identity)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(n > _EPS, q / torch.clamp(n, min=_EPS),
                       identity(q.dtype, q.device))


def to_rvec(q):
    """Rotation vector from unit quaternion; minimal rotation (angle in
    [0, pi]) by flipping sign when w < 0."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    q = normalize(q)
    s = torch.linalg.vector_norm(q[..., :3], dim=-1, keepdim=True)
    w = q[..., 3:4]
    angle = 2.0 * torch.atan2(s, w)
    k = torch.where(s > _EPS, angle / torch.clamp(s, min=_EPS),
                    torch.full_like(s, 2.0))
    return q[..., :3] * k


def from_matrix(R):
    """Unit quaternion from rotation matrix [..., 3, 3] (Shepperd's method).

    Branch-free: computes all four candidate quaternions and selects the one
    keyed by the largest of (trace, R00, R11, R22)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates (unnormalized, (w, x, y, z)), each valid when its
    # pivot is largest.
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 + m22 - m00 - m11], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)   # [..., case, wxyz]
    pivots = torch.stack([tr, m00, m11, m22], dim=-1)
    case = torch.argmax(pivots, dim=-1)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    sel = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.stack([sel[..., 1], sel[..., 2], sel[..., 3], sel[..., 0]],
                    dim=-1)
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return normalize(q)
