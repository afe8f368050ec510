"""Absolute trajectory error: Horn closed-form SE(3) alignment + statistics.

Semantics of the TUM benchmark tool (reference: Work/SLAM/tools/
tum_benchmark_tools/evaluate_ate.py:49-81 align, :153-163 statistics).
"""

from typing import NamedTuple

import numpy as np

from mqslam_tpu_torch.eval.associate import associate_arrays

__all__ = ["horn_align", "AteResult", "evaluate_ate", "evaluate_ate_files"]


class AteResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n_pairs: int
    rotation: np.ndarray      # [3, 3] aligning model -> data
    translation: np.ndarray   # [3]
    trans_error: np.ndarray   # [n]
    matches: np.ndarray       # [n, 2] int (est index, gt index) pairs


def horn_align(model, data):
    """Closed-form rigid alignment of model [n,3] onto data [n,3]
    (evaluate_ate.py:49-81). Returns (R, t, per-point translational error)."""
    model = np.asarray(model, dtype=np.float64).T  # 3xn
    data = np.asarray(data, dtype=np.float64).T
    mc = model - model.mean(1, keepdims=True)
    dc = data - data.mean(1, keepdims=True)
    W = mc @ dc.T
    U, d, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    R = U @ S @ Vh
    t = data.mean(1) - R @ model.mean(1)
    aligned = R @ model + t[:, None]
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return R, t, err


def evaluate_ate(traj_est, traj_gt, max_difference=0.02, offset=0.0,
                 scale=1.0) -> AteResult:
    """ATE between two CamTrajectory tuples (est aligned onto gt)."""
    matches = associate_arrays(traj_est.timestamps, traj_gt.timestamps,
                               offset, max_difference)
    if len(matches) < 2:
        raise ValueError(
            f"Only {len(matches)} matched pose pairs — check timestamps.")
    i1 = [i for i, _ in matches]
    i2 = [j for _, j in matches]
    est = np.asarray(traj_est.locations)[i1] * scale
    gt = np.asarray(traj_gt.locations)[i2]
    R, t, err = horn_align(est, gt)
    return AteResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        std=float(np.std(err)),
        min=float(np.min(err)),
        max=float(np.max(err)),
        n_pairs=len(matches),
        rotation=R, translation=t, trans_error=err,
        matches=np.asarray(matches, dtype=np.int64).reshape(-1, 2))


def evaluate_ate_files(est_file, gt_file, **kw) -> AteResult:
    from mqslam_tpu_torch.io import tum
    return evaluate_ate(tum.load_trajectory(est_file),
                        tum.load_trajectory(gt_file), **kw)
