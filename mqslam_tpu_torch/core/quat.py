"""Quaternion algebra, batched over leading dims.

Convention: quaternions are stored as ``(x, y, z, w)`` — the TUM trajectory
convention — in tensors of shape ``[..., 4]``.  Unit rotation quaternions
act on points by conjugation q * p * q^-1.
"""

import torch

__all__ = ["identity", "normalize", "mult", "conj", "inv", "delta",
           "apply_to_point", "from_rvec", "to_rvec", "to_matrix",
           "from_matrix", "axis_angle_from_rvec"]

_EPS = 1e-12


def identity(dtype=torch.float32, device=None):
    """The identity rotation quaternion (0, 0, 0, 1), made on ``device``
    (no host-to-device copy, such as storing a Python number into it: on a
    CUDA device that copy waits for the stream, and no CUDA graph can
    capture it)."""
    return torch.eye(4, dtype=dtype, device=device)[3]


def normalize(q):
    """Normalize to unit length (safe at ~zero norm: returns identity)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(n > _EPS, q / torch.clamp(n, min=_EPS),
                       identity(q.dtype, q.device))


def mult(q1, q2):
    """Hamilton product q1 * q2 (apply q2's rotation first, then q1's)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def conj(q):
    """Conjugate (negate the vector part)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def inv(q):
    """Inverse q^-1 = conj(q) / |q|^2."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return conj(q) / torch.clamp(n2, min=_EPS)


def delta(q1, q2):
    """Relative rotation taking q1 to q2: q2 * q1^-1."""
    return mult(q2, inv(q1))


def _cross(a, b):
    """a x b over the last axis, term by term as ``jnp.cross`` writes it."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def apply_to_point(q, p):
    """Rotate point(s) p [..., 3] by unit quaternion(s) q [..., 4] (the
    expanded conjugation formula, no intermediate quaternion)."""
    v = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(v, p)
    return p + w * t + _cross(v, t)


def from_rvec(rvec):
    """Unit quaternion from rotation vector (axis * angle)."""
    angle = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    half = 0.5 * angle
    # sinc-safe: sin(half)/angle -> 0.5 as angle -> 0; the clamp keeps the
    # untaken side finite, so its gradient is too
    k = torch.where(angle > _EPS,
                    torch.sin(half) / torch.clamp(angle, min=_EPS),
                    torch.full_like(angle, 0.5))
    return torch.cat([rvec * k, torch.cos(half)], dim=-1)


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


def axis_angle_from_rvec(rvec):
    """(unit axis, angle) of a rotation vector; the zero rotation's axis is
    (0, 0, 1), so the axis is always unit."""
    angle = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    z = torch.zeros(3, dtype=rvec.dtype, device=rvec.device)
    z[2] = 1.0
    axis = torch.where(angle > _EPS, rvec / torch.clamp(angle, min=_EPS), z)
    return axis, angle[..., 0]


def to_matrix(q):
    """3x3 rotation matrix from unit quaternion, shape [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


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
