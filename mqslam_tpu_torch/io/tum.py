"""TUM RGB-D trajectory format: ``timestamp tx ty tz qx qy qz qw`` per line.

Wire-compatible with the reference's loader/saver
(reference: Work/python_libs/dataset_tools.py:71-115); commas/tabs are
tolerated on load, quaternions are normalized, '#' starts a comment.
Poses are camera-to-world (camera center + orientation), i.e. the inverse of
the extrinsic matrix P — see mqslam_tpu_torch.core.se3.{from,to}_pose_tum.
"""

from typing import NamedTuple

import numpy as np

__all__ = ["CamTrajectory", "load_trajectory", "save_trajectory",
           "trajectory_from_extrinsics", "extrinsics_from_trajectory"]


class CamTrajectory(NamedTuple):
    """timestamps [N]; locations [N, 3]; quaternions [N, 4] (xyzw)."""
    timestamps: np.ndarray
    locations: np.ndarray
    quaternions: np.ndarray

    def __len__(self):
        return len(self.timestamps)


def load_trajectory(filename) -> CamTrajectory:
    """Parse a TUM trajectory file (dataset_tools.py:71-96 semantics)."""
    rows = []
    with open(filename) as f:
        for line in f.read().replace(",", " ").replace("\t", " ").split("\n"):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 8:
                raise ValueError(
                    f"TUM trajectory line has {len(vals)} fields, want 8: "
                    f"{line!r}")
            rows.append(vals)
    if not rows:
        return CamTrajectory(np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4)))
    a = np.asarray(rows, dtype=np.float64)
    q = a[:, 4:8]
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    q = q / np.where(norms > 0, norms, 1.0)
    return CamTrajectory(a[:, 0], a[:, 1:4], q)


def save_trajectory(filename, traj: CamTrajectory):
    """Write a TUM trajectory file (dataset_tools.py:99-115 layout)."""
    lines = [
        "# Format: timestamp tx ty tz qx qy qz qw",
        "# Where translations and quaternions are defined in world coordinates"
        " (=> inverse of pose)",
    ]
    for t, l, q in zip(traj.timestamps, traj.locations, traj.quaternions):
        lines.append(" ".join(map(repr, (float(t), *map(float, l),
                                         *map(float, q)))))
    lines.append("")
    with open(filename, "w") as f:
        f.write("\n".join(lines))


def trajectory_from_extrinsics(timestamps, P) -> CamTrajectory:
    """4x4 extrinsics [N, 4, 4] -> TUM trajectory (cam-to-world poses).

    Semantics of dataset_tools.py:275-294 (convert_cam_poses_to_cam_
    trajectory_TUM); NumPy-side convenience over core.se3.to_pose_tum.
    """
    from mqslam_tpu_torch.io.nputil import matrix_to_quat_np
    P = np.asarray(P, dtype=np.float64)
    Rcw = np.swapaxes(P[..., :3, :3], -1, -2)
    c = -np.einsum("...ij,...j->...i", Rcw, P[..., :3, 3])
    q = matrix_to_quat_np(Rcw)
    return CamTrajectory(np.asarray(timestamps, dtype=np.float64), c, q)


def extrinsics_from_trajectory(traj: CamTrajectory):
    """TUM trajectory -> 4x4 extrinsics [N, 4, 4] (world-to-cam)."""
    from mqslam_tpu_torch.io.nputil import quat_to_matrix_np
    Rcw = quat_to_matrix_np(traj.quaternions)
    R = np.swapaxes(Rcw, -1, -2)
    t = -np.einsum("...ij,...j->...i", R,
                   np.asarray(traj.locations, dtype=np.float64))
    n = len(traj.timestamps)
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = R
    P[:, :3, 3] = t
    return P
