"""Pure-NumPy quaternion/rotation helpers for host-side IO.

IO code is host code: parsing a trajectory must not launch device work or
wait for a device.  These mirror mqslam_tpu_torch.core.quat semantics (xyzw)
exactly.
"""

import numpy as np

__all__ = ["quat_to_matrix_np", "matrix_to_quat_np", "normalize_quat_np"]


def normalize_quat_np(q):
    q = np.asarray(q, dtype=np.float64)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.where(n > 1e-12, n, 1.0)


def quat_to_matrix_np(q):
    """xyzw quaternion(s) [..., 4] -> rotation matrices [..., 3, 3]."""
    q = normalize_quat_np(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat_np(R):
    """Rotation matrices [..., 3, 3] -> xyzw quaternions (Shepperd)."""
    R = np.asarray(R, dtype=np.float64)
    batch = R.shape[:-2]
    Rf = R.reshape((-1, 3, 3))
    out = np.empty((Rf.shape[0], 4))
    for i, m in enumerate(Rf):
        tr = m[0, 0] + m[1, 1] + m[2, 2]
        cand = np.array([tr, m[0, 0], m[1, 1], m[2, 2]])
        case = int(np.argmax(cand))
        if case == 0:
            s = np.sqrt(max(tr + 1.0, 0.0)) * 2
            w = 0.25 * s
            x = (m[2, 1] - m[1, 2]) / s
            y = (m[0, 2] - m[2, 0]) / s
            z = (m[1, 0] - m[0, 1]) / s
        elif case == 1:
            s = np.sqrt(max(1.0 + m[0, 0] - m[1, 1] - m[2, 2], 0.0)) * 2
            w = (m[2, 1] - m[1, 2]) / s
            x = 0.25 * s
            y = (m[0, 1] + m[1, 0]) / s
            z = (m[0, 2] + m[2, 0]) / s
        elif case == 2:
            s = np.sqrt(max(1.0 + m[1, 1] - m[0, 0] - m[2, 2], 0.0)) * 2
            w = (m[0, 2] - m[2, 0]) / s
            x = (m[0, 1] + m[1, 0]) / s
            y = 0.25 * s
            z = (m[1, 2] + m[2, 1]) / s
        else:
            s = np.sqrt(max(1.0 + m[2, 2] - m[0, 0] - m[1, 1], 0.0)) * 2
            w = (m[1, 0] - m[0, 1]) / s
            x = (m[0, 2] + m[2, 0]) / s
            y = (m[1, 2] + m[2, 1]) / s
            z = 0.25 * s
        q = np.array([x, y, z, w])
        if q[3] < 0:
            q = -q
        out[i] = q / np.linalg.norm(q)
    return out.reshape(batch + (4,))
