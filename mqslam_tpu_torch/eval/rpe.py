"""Relative pose error over pose pairs.

Exact semantics of the TUM benchmark tool (reference: Work/SLAM/tools/
tum_benchmark_tools/evaluate_rpe.py:204-297): in fixed-delta mode, each
estimated pose i pairs with the closest index j at distance ``delta`` along
the chosen axis (seconds / frames / meters / radians), pairs reaching the
final index are dropped (:263-266); ground-truth endpoints match by nearest
stamp within 2x the median ground-truth interval (:270-284); the error
motion is E = (gt_rel)^-1 (est_rel) with translational |t(E)| and rotational
angle(E).
"""

from typing import NamedTuple

import numpy as np

from mqslam_tpu_torch.io.nputil import quat_to_matrix_np

__all__ = ["RpeResult", "evaluate_rpe"]


class RpeResult(NamedTuple):
    trans_rmse: float
    trans_mean: float
    trans_median: float
    trans_std: float
    trans_min: float
    trans_max: float
    rot_rmse: float            # radians
    rot_mean: float
    rot_median: float
    n_pairs: int
    trans_errors: np.ndarray
    rot_errors: np.ndarray
    pair_stamps: np.ndarray    # [n, 4] (stamp_est0, stamp_est1,
    #                            stamp_gt0, stamp_gt1) per evaluated pair


def _se3_of(traj):
    R = quat_to_matrix_np(traj.quaternions)
    out = np.tile(np.eye(4), (len(traj.timestamps), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = traj.locations
    return out


def _find_closest(sorted_arr, value):
    """The reference's binary search, replicated bug-for-bug
    (evaluate_rpe.py:112-138): it tracks the best midpoint visited, which is
    not always the globally closest element — pair selection must match to
    reproduce the published numbers exactly."""
    beginning = 0
    difference = abs(sorted_arr[0] - value)
    best = 0
    end = len(sorted_arr)
    while beginning < end:
        middle = (end + beginning) // 2
        if abs(sorted_arr[middle] - value) < difference:
            difference = abs(sorted_arr[middle] - value)
            best = middle
        if value == sorted_arr[middle]:
            return middle
        elif sorted_arr[middle] > value:
            end = middle
        else:
            beginning = middle + 1
    return best


def _distances_along(P):
    d = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _rotations_along(P, scale):
    rels = np.einsum("nij,njk->nik", np.linalg.inv(P[:-1]), P[1:])
    angles = [np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1))
              for E in rels]
    return np.concatenate([[0.0], np.cumsum(angles)]) * scale


def evaluate_rpe(traj_est, traj_gt, fixed_delta=True, delta=1.0,
                 delta_unit="s", max_pairs=10000, offset=0.0, scale=1.0,
                 seed=0) -> RpeResult:
    """RPE between two CamTrajectory tuples (est vs gt).

    delta_unit in {'s', 'f', 'm', 'rad', 'deg'}.
    """
    ts_est = np.asarray(traj_est.timestamps, dtype=np.float64)
    ts_gt = np.asarray(traj_gt.timestamps, dtype=np.float64)
    order_e = np.argsort(ts_est)
    order_g = np.argsort(ts_gt)
    ts_est = ts_est[order_e]
    ts_gt = ts_gt[order_g]
    P = _se3_of(type(traj_est)(ts_est, traj_est.locations[order_e],
                               traj_est.quaternions[order_e]))
    Q = _se3_of(type(traj_gt)(ts_gt, traj_gt.locations[order_g],
                              traj_gt.quaternions[order_g]))
    n = len(P)

    if delta_unit == "s":
        index_est = ts_est
    elif delta_unit == "f":
        index_est = np.arange(n, dtype=np.float64)
    elif delta_unit == "m":
        index_est = _distances_along(P)
    elif delta_unit == "rad":
        index_est = _rotations_along(P, 1.0)
    elif delta_unit == "deg":
        index_est = _rotations_along(P, 180.0 / np.pi)
    else:
        raise ValueError(f"Unknown delta_unit {delta_unit!r}")

    if fixed_delta:
        pairs = []
        for i in range(n):
            j = _find_closest(index_est, index_est[i] + delta)
            if j != n - 1:
                pairs.append((i, j))
        if max_pairs and len(pairs) > max_pairs:
            rng = np.random.RandomState(seed)
            pairs = [pairs[k] for k in
                     rng.choice(len(pairs), max_pairs, replace=False)]
    else:
        rng = np.random.RandomState(seed)
        if max_pairs == 0 or n < np.sqrt(max_pairs):
            pairs = [(i, j) for i in range(n) for j in range(n)]
        else:
            pairs = list(zip(rng.randint(0, n, max_pairs),
                             rng.randint(0, n, max_pairs)))

    gt_interval = float(np.median(np.diff(ts_gt))) if len(ts_gt) > 1 else 0.0
    gt_max_dt = 2.0 * gt_interval

    te, re, pair_stamps = [], [], []
    for i, j in pairs:
        gi = _find_closest(ts_gt, ts_est[i] + offset)
        gj = _find_closest(ts_gt, ts_est[j] + offset)
        if (abs(ts_gt[gi] - (ts_est[i] + offset)) > gt_max_dt
                or abs(ts_gt[gj] - (ts_est[j] + offset)) > gt_max_dt):
            continue
        pair_stamps.append((ts_est[i], ts_est[j], ts_gt[gi], ts_gt[gj]))
        # literal reference formula (evaluate_rpe.py:285-287 with
        # ominus(a, b) = inv(a) @ b — note the argument order):
        # E = ominus(scale(ominus(est_j, est_i)), ominus(gt_j, gt_i))
        est_rel = np.linalg.inv(P[j]) @ P[i]
        est_rel = est_rel.copy()
        est_rel[:3, 3] *= scale
        gt_rel = np.linalg.inv(Q[gj]) @ Q[gi]
        E = np.linalg.inv(est_rel) @ gt_rel
        te.append(np.linalg.norm(E[:3, 3]))
        re.append(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
    if len(te) < 2:
        raise ValueError("Couldn't find matching timestamp pairs.")
    te = np.asarray(te)
    re = np.asarray(re)
    return RpeResult(
        trans_rmse=float(np.sqrt(np.mean(te ** 2))),
        trans_mean=float(np.mean(te)),
        trans_median=float(np.median(te)),
        trans_std=float(np.std(te)),
        trans_min=float(np.min(te)),
        trans_max=float(np.max(te)),
        rot_rmse=float(np.sqrt(np.mean(re ** 2))),
        rot_mean=float(np.mean(re)),
        rot_median=float(np.median(re)),
        n_pairs=len(te),
        trans_errors=te, rot_errors=re,
        pair_stamps=np.asarray(pair_stamps, dtype=np.float64
                               ).reshape(-1, 4))
