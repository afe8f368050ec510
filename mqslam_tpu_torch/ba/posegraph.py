"""SE(3) pose-graph optimization (GTSAM-style BetweenFactor graphs).

The reference's back-end expresses odometry and cross-camera constraints as
BetweenFactor<Pose3> edges inside the full BA graph (reference:
Work/SLAM/tools/bundle_adjustment/bundle_adjust.cpp:301-309,
DataStructures.hpp:35-41). Pose-graph optimization is the landmark-free
specialization of that graph — the standard back-end for loop closure
(frontend.loopclosure produces the edges).

Every edge is linearized at once (the closed-form Jacobians of
``ba/factors.py``: the JAX package takes them from ``vmap(jacfwd)``), the
Gauss-Newton system is applied matrix-free as per-edge 6x6 block products +
``index_add_`` over pose ids, solved by block-Jacobi-preconditioned CG, with
Levenberg damping and a monotone accept/reject outer loop. Poses update by
manifold retraction (``factors.retract_single``), never by raw axis-angle
addition.  The iteration counts are fixed and accept/reject is a
``torch.where``, so a solve reads nothing back to the host.

All tensors are fixed capacity with validity masks.
"""

from typing import NamedTuple

import torch

from mqslam_tpu_torch.ba import factors
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.ops import linalg

__all__ = ["PoseGraph", "pgo_cost", "pgo_solve"]


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph. poses [N, 6] are cam-to-world
    (rvec, center) as everywhere in ba/; edges i->j carry the measured
    relative pose (meas_r, meas_t) with Between semantics
    R_i^T R_j ~ Exp(meas_r), R_i^T (c_j - c_i) ~ meas_t."""
    poses: torch.Tensor        # [N, 6]
    pose_valid: torch.Tensor   # [N] bool
    edge_i: torch.Tensor       # [E] int32
    edge_j: torch.Tensor       # [E] int32
    edge_meas_r: torch.Tensor  # [E, 3]
    edge_meas_t: torch.Tensor  # [E, 3]
    edge_inv_sigma: torch.Tensor  # [E, 6] whitening (rot xyz, trans xyz)
    edge_valid: torch.Tensor   # [E] bool
    # gauge prior (first pose by convention; any subset works)
    prior_mask: torch.Tensor   # [N] bool
    prior_r: torch.Tensor      # [N, 3]
    prior_t: torch.Tensor      # [N, 3]
    prior_inv_sigma: torch.Tensor  # [N, 6]


def _masked(mask, x):
    """x where mask (broadcast over x's trailing dims), else 0."""
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    return torch.where(m, x, torch.zeros_like(x))


def _ends(g: PoseGraph, poses):
    return poses[g.edge_i.long()], poses[g.edge_j.long()]


def _edge_residuals(g: PoseGraph, poses):
    pf, pt = _ends(g, poses)
    return _masked(g.edge_valid, factors.odo_residual(
        pf, pt, g.edge_meas_r, g.edge_meas_t, g.edge_inv_sigma))


def _prior_residuals(g: PoseGraph, poses):
    return _masked(g.prior_mask, factors.prior_pose_residual(
        poses, g.prior_r, g.prior_t, g.prior_inv_sigma))


def pgo_cost(g: PoseGraph, poses=None):
    """0.5 * sum of squared whitened residuals (GTSAM's error)."""
    poses = g.poses if poses is None else poses
    re = _edge_residuals(g, poses)
    rp = _prior_residuals(g, poses)
    return 0.5 * (torch.sum(re * re) + torch.sum(rp * rp))


def _linearize(g: PoseGraph, poses):
    pf, pt = _ends(g, poses)
    Jf, Jt = factors.odo_residual_jac(pf, pt, g.edge_meas_r, g.edge_meas_t,
                                      g.edge_inv_sigma)  # [E, 6, 6] x2
    r = factors.odo_residual(pf, pt, g.edge_meas_r, g.edge_meas_t,
                             g.edge_inv_sigma)
    Jp = factors.prior_pose_residual_jac(poses, g.prior_r, g.prior_t,
                                         g.prior_inv_sigma)  # [N, 6, 6]
    rp = factors.prior_pose_residual(poses, g.prior_r, g.prior_t,
                                     g.prior_inv_sigma)
    return (_masked(g.edge_valid, Jf), _masked(g.edge_valid, Jt),
            _masked(g.edge_valid, r), _masked(g.prior_mask, Jp),
            _masked(g.prior_mask, rp))


def _segment_sum(vals, ids, n):
    """[n, ...] sums of ``vals`` rows by ``ids`` (``segment_sum``)."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids.long(), vals)


def _gram66(J):
    # broadcast+sum as the JAX package (no matmul: full float32 anywhere)
    return torch.sum(J[:, :, :, None] * J[:, :, None, :], dim=1)


def _jt_r(J, r):
    """J^T r per block: [B, 6, 6], [B, 6] -> [B, 6]."""
    return torch.sum(J * r[:, :, None], dim=-2)


def _make_Hv(g: PoseGraph, Jf, Jt, Jp, lam, diag):
    """Matrix-free damped GN operator on [N, 6] pose increments."""
    N = g.poses.shape[0]

    def Hv(v):
        vf, vt = _ends(g, v)
        Jv = (torch.sum(Jf * vf[:, None, :], dim=-1)
              + torch.sum(Jt * vt[:, None, :], dim=-1))     # [E, 6]
        out = _segment_sum(_jt_r(Jf, Jv), g.edge_i, N)
        out = out + _segment_sum(_jt_r(Jt, Jv), g.edge_j, N)
        Jpv = torch.sum(Jp * v[:, None, :], dim=-1)
        out = out + _jt_r(Jp, Jpv)
        return out + lam * diag * v

    return Hv


def _block_diag(g: PoseGraph, Jf, Jt, Jp):
    """[N, 6, 6] block diagonal of the GN matrix (for preconditioning)."""
    N = g.poses.shape[0]
    D = _segment_sum(_gram66(Jf), g.edge_i, N)
    D = D + _segment_sum(_gram66(Jt), g.edge_j, N)
    return D + _gram66(Jp)


def _pcg(Hv, b, Dd_blocks, iters):
    """Block-Jacobi preconditioned CG on the [N, 6] increment; the
    preconditioner solve is the closed-form SPD 6x6 (no inverse storage).
    ``iters`` iterations, no early exit."""
    x = torch.zeros_like(b)
    r = b
    z = linalg.solve6x6_spd(Dd_blocks, r)
    p = z
    for _ in range(iters):
        Hp = Hv(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z2 = linalg.solve6x6_spd(Dd_blocks, r)
        beta = torch.sum(r * z2) / torch.clamp(rz, min=1e-30)
        z = z2
        p = z2 + beta * p
    return x


def _retract_all(poses, delta, active):
    R, c = factors.retract_single(poses, delta)
    newp = torch.cat([so3.log(R), c], dim=-1)
    return torch.where(active[:, None], newp, poses)


def pgo_solve(g: PoseGraph, iters: int = 20, cg_iters: int = 60,
              lam0: float = 1e-4):
    """Levenberg-damped Gauss-Newton over the pose graph.

    Returns (poses [N, 6], final_cost, lam) as tensors on the graph's
    device. Invalid poses pass through unchanged; the gauge is fixed by the
    prior entries.
    """
    active = g.pose_valid
    N = g.poses.shape[0]
    eye6 = torch.eye(6, dtype=g.poses.dtype, device=g.poses.device)
    poses = g.poses
    lam = torch.tensor(lam0, dtype=g.poses.dtype, device=g.poses.device)
    cost = pgo_cost(g)
    for _ in range(iters):
        Jf, Jt, r, Jp, rp = _linearize(g, poses)
        b = -(_segment_sum(_jt_r(Jf, r), g.edge_i, N)
              + _segment_sum(_jt_r(Jt, r), g.edge_j, N)
              + _jt_r(Jp, rp))
        D = _block_diag(g, Jf, Jt, Jp)
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-8)
        Hv = _make_Hv(g, Jf, Jt, Jp, lam, diag)
        Dd = D + (lam * diag + 1e-8)[:, :, None] * eye6
        delta = _pcg(Hv, b, Dd, cg_iters)
        new_poses = _retract_all(poses, delta, active)
        new_cost = pgo_cost(g, new_poses)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
    return poses, cost, lam
