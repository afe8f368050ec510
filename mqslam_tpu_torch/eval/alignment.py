"""Scale-aware trajectory/map alignment for monocular outputs.

Semantics of the reference's anchored quat+scale+translation transform
(reference: Work/python_libs/dataset_tools.py:297-409 and its use in
Work/SLAM/tools/align_traj_and_map_to_groundtruth.py:60-95): the transform is
anchored at one matched pose (not least-squares over the whole trajectory),
with the scale inferred from the motion between two moments.

The quaternion algebra runs in float32 tensors on ``device`` (None: the
CUDA device), as the JAX package's runs in float32 without 64-bit mode; the
rest is NumPy, with the JAX package's dtypes at every step (the rotation
comes back as a float32 array, the scale and translation in float64).
"""

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import quat as quat_mod

__all__ = ["transform_between_trajectories", "transform_points",
           "transform_trajectory"]


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32)).to(device)


def _np(x):
    return x.cpu().numpy()


def _closest(array, element):
    if abs(element) != float("inf"):
        return int(np.abs(np.asarray(array) - element).argmin())
    return len(array) - 1 if element > 0 else 0


def transform_between_trajectories(traj_from, traj_to, at_frame=1,
                                   at_time=None, infer_scale=True,
                                   offset_frames=None,
                                   offset_time=float("inf"), device=None):
    """(delta_quaternion, delta_scale, delta_location) mapping traj_from onto
    traj_to (dataset_tools.py:297-379)."""
    device = resolve_device(device)
    ts_from, locs_from, quats_from = traj_from
    ts_to, locs_to, quats_to = traj_to
    if not len(ts_from) or not len(ts_to):
        return np.array([0.0, 0.0, 0.0, 1.0]), 1.0, np.zeros(3)

    if at_frame is not None:
        at_to = max(0, min(at_frame - 1, len(ts_to) - 1))
    else:
        at_to = _closest(ts_to, at_time)
    at_from = _closest(ts_from, ts_to[at_to])
    at_to = _closest(ts_to, ts_from[at_from])
    at_time = ts_to[at_to]

    dq = _np(quat_mod.mult(_t(quats_to[at_to], device),
                           quat_mod.inv(_t(quats_from[at_from], device))))
    loc_from = locs_from[at_from]
    loc_to = locs_to[at_to]

    scale = 1.0
    if infer_scale:
        if offset_frames is not None:
            snd_to = max(0, min(at_to + offset_frames, len(ts_to) - 1))
        else:
            snd_to = _closest(ts_to, at_time + offset_time)
        snd_from = _closest(ts_from, ts_to[snd_to])
        snd_to = _closest(ts_to, ts_from[snd_from])
        v_from = _np(quat_mod.apply_to_point(
            _t(dq, device), _t(locs_from[snd_from] - loc_from, device)))
        v_to = locs_to[snd_to] - locs_to[at_to]
        denom = float(v_from @ v_from)
        if denom != 0.0:
            scale = float(v_from @ v_to) / denom

    d_loc = loc_to - scale * _np(
        quat_mod.apply_to_point(_t(dq, device), _t(loc_from, device)))
    return dq, scale, d_loc


def transform_points(points, transformation, device=None):
    """Apply (dq, scale, dloc) to points [n, 3] (dataset_tools.py:382-392)."""
    device = resolve_device(device)
    dq, scale, dloc = transformation
    rotated = _np(quat_mod.apply_to_point(
        _t(dq, device), _t(np.asarray(points, dtype=np.float64), device)))
    return dloc + scale * rotated


def transform_trajectory(traj, transformation, device=None):
    """Apply (dq, scale, dloc) to a CamTrajectory
    (dataset_tools.py:395-409)."""
    from mqslam_tpu_torch.io import tum
    device = resolve_device(device)
    dq, scale, dloc = transformation
    locs = transform_points(traj.locations, transformation, device)
    quats = _np(quat_mod.mult(_t(dq, device), _t(traj.quaternions, device)))
    return tum.CamTrajectory(np.asarray(traj.timestamps), locs, quats)
