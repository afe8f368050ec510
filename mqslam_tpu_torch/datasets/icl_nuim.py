"""ICL-NUIM dataset adapter: exact POV-Ray ground truth + trajectory repair.

Equivalents of the reference's reparation tooling (reference:
Work/SLAM/datasets/ICL_NUIM/icl_nuim_reparation.py): the dataset's noisy
freiburg ground-truth files need a z-flip + quaternion permutation to match
the non-mirrored scene, and the exact trajectory hides in the checked-in
POV-Ray render commands. The dataset's intrinsics carry fy = -480 (mirrored
render) which the whole framework supports natively.
"""

import numpy as np

from mqslam_tpu_torch.io import tum

__all__ = ["load_cam_poses_pov", "repair_cam_trajectory",
           "mirror_wavefront_obj"]


def load_cam_poses_pov(filename):
    """Parse a POV-Ray render-command script into exact extrinsics [N, 4, 4].

    Each line carries Declare=valRC=... entries forming a 4x3 cam-to-world
    matrix (icl_nuim_reparation.py:17-50); the world-to-cam inverse is
    returned, matching the reference.
    """
    Ps = []
    with open(filename) as f:
        for line in f.read().split("\n"):
            if not line:
                continue
            vals = [float(tok[3:tok.find("+")])
                    for tok in line.split("Declare=val")[1:]]
            M = np.eye(4)
            M[0:3, 0:4] = np.asarray(vals).reshape(4, 3).T
            R = M[:3, :3]
            t = M[:3, 3]
            P = np.eye(4)
            P[:3, :3] = R.T
            P[:3, 3] = -R.T @ t
            Ps.append(P)
    return np.stack(Ps)


def repair_cam_trajectory(traj: "tum.CamTrajectory", initial_location=None,
                          rebuild_timestamps=True, delta_timestamp=0.0,
                          fps=30):
    """Fix an ICL-NUIM freiburg trajectory for the non-mirrored scene:
    z-flip of locations and the (qw, qz, qy, -qx) quaternion permutation
    (icl_nuim_reparation.py:80-125). Returns a new CamTrajectory."""
    locations = np.asarray(traj.locations, dtype=np.float64).copy()
    quats = np.asarray(traj.quaternions, dtype=np.float64).copy()
    ts = np.asarray(traj.timestamps, dtype=np.float64).copy()

    if initial_location is not None:
        delta = np.asarray(initial_location, dtype=np.float64) - locations[0]
    else:
        delta = np.zeros(3)
    if rebuild_timestamps:
        ts = delta_timestamp + (1 + np.arange(len(ts))) / float(fps)

    locations = np.stack([locations[:, 0], locations[:, 1],
                          -locations[:, 2]], axis=1) + delta
    qx, qy, qz, qw = quats.T
    quats = np.stack([qw, qz, qy, -qx], axis=1)
    return tum.CamTrajectory(ts, locations, quats)


def mirror_wavefront_obj(filename_in, filename_out):
    """Mirror x of vertices/normals in a Wavefront OBJ
    (icl_nuim_reparation.py:55-77; face order untouched)."""
    with open(filename_in) as f:
        lines = f.read().split("\n")
    for i, line in enumerate(lines):
        words = line.split(" ")
        if words and words[0] in ("v", "vn"):
            words[1] = str(-float(words[1]))
            lines[i] = " ".join(words)
    with open(filename_out, "w") as f:
        f.write("\n".join(lines))
