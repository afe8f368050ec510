"""Batched two-view triangulation.

What the keyframe phase of the front-end uses: ``linear_eigen`` (homogeneous
DLT, smallest eigenvector of A^T A) and ``optimal`` (Lindstrom's closed-form
two-step epipolar correction, "Triangulation Made Easy", CVPR 2010, followed
by the DLT).  ``linear_ls`` and ``iterative_ls`` of the JAX package are not
ported yet.

Inputs are normalized image coordinates ``u1, u2: [..., N, 2]`` and camera
matrices ``P1, P2: [..., 3+, 4]`` whose batch dims match the points' batch
dims without the N axis (only the first 3 rows are used, so 4x4 extrinsics
work directly).  Status is bool, False for non-finite / huge points.
"""

import torch

from mqslam_tpu_torch.ops import linalg

__all__ = ["linear_eigen", "optimal", "fundamental_from_P"]


def _prep(P):
    """[..., 3+, 4] -> [..., 1, 3, 4]: the inserted axis aligns with the
    points' N axis so all row operations broadcast elementwise."""
    return P[..., None, :3, :4]


def _rows(u, Pp):
    """Per-point DLT rows for one camera (Pp pre-shaped by _prep).

    For image point (ux, uy): rows  ux*P[2,:] - P[0,:]  and
    uy*P[2,:] - P[1,:], split into the 3-column part and the (negated)
    constant part.  Returns (A [..., N, 2, 3], b [..., N, 2])."""
    ux = u[..., 0]
    uy = u[..., 1]
    r0, r1, r2 = Pp[..., 0, :], Pp[..., 1, :], Pp[..., 2, :]  # [..., 1, 4]
    a0 = ux[..., None] * r2[..., :3] - r0[..., :3]
    a1 = uy[..., None] * r2[..., :3] - r1[..., :3]
    A = torch.stack([a0, a1], dim=-2)
    b0 = -(ux * r2[..., 3] - r0[..., 3])
    b1 = -(uy * r2[..., 3] - r1[..., 3])
    b = torch.stack([b0, b1], dim=-1)
    return A, b


def _depth(Pp, x):
    """Depth of inhomogeneous 3D points x [..., N, 3] under camera Pp
    (pre-shaped by _prep): P[2,:3].x + P[2,3]."""
    return torch.sum(Pp[..., 2, :3] * x, dim=-1) + Pp[..., 2, 3]


def linear_eigen(u1, P1, u2, P2, max_coordinate_value=1e16):
    """Homogeneous DLT: smallest eigenvector of the 4x4 A^T A per point
    (cv2.triangulatePoints semantics): solve min |A xh| s.t. |xh| = 1,
    dehomogenize, flag huge / non-finite points False."""
    A1, b1 = _rows(u1, _prep(P1))
    A2, b2 = _rows(u2, _prep(P2))
    rows = torch.cat([
        torch.cat([A1, -b1[..., None]], dim=-1),
        torch.cat([A2, -b2[..., None]], dim=-1),
    ], dim=-2)  # [..., N, 4, 4]
    S = linalg.gram(rows)
    xh = linalg.eigh4x4_smallest(S)
    w = xh[..., 3]
    w_safe = torch.where(torch.abs(w) > 1e-30, w, torch.full_like(w, 1e-30))
    x = xh[..., :3] / w_safe[..., None]
    # Points at infinity dehomogenize to ~1/eps(dtype), so the f64 cutoff of
    # 1e16 is scaled down for lower precisions
    cutoff = min(max_coordinate_value, 0.1 / torch.finfo(u1.dtype).eps)
    status = torch.amax(torch.abs(x), dim=-1) <= cutoff
    status = status & torch.all(torch.isfinite(x), dim=-1)
    return x, status


def fundamental_from_P(P1, P2):
    """Fundamental (= essential, in normalized coords) matrix from two camera
    matrices: F = [t]x R of the relative pose P2 @ P1^-1; constraint
    convention u2h^T F u1h = 0."""
    R1 = P1[..., :3, :3]
    t1 = P1[..., :3, 3]
    R1T = R1.transpose(-1, -2)
    Rrel = linalg.matmul_small(P2[..., :3, :3], R1T)
    trel = P2[..., :3, 3] - linalg.matvec_small(Rrel, t1)
    tx, ty, tz = trel[..., 0], trel[..., 1], trel[..., 2]
    zero = torch.zeros_like(tx)
    Tx = torch.stack([
        torch.stack([zero, -tz, ty], dim=-1),
        torch.stack([tz, zero, -tx], dim=-1),
        torch.stack([-ty, tx, zero], dim=-1),
    ], dim=-2)
    return linalg.matmul_small(Tx, Rrel)


def _optimal_correct(u1, u2, F):
    """Lindstrom niter2 epipolar correction of point pairs: moves (u1, u2)
    the minimum summed squared distance onto u2h^T F u1h = 0."""
    E = F[..., None, :, :]  # align batch with the points' N axis
    x2 = u2
    x1 = u1
    Ebar = E[..., :2, :2]
    EbarT = Ebar.transpose(-1, -2)

    n = linalg.matvec_small(Ebar, x1) + E[..., :2, 2]      # d/dx2
    n_p = linalg.matvec_small(EbarT, x2) + E[..., 2, :2]   # d/dx1
    a = torch.sum(n * linalg.matvec_small(Ebar, n_p), dim=-1)
    b = 0.5 * (torch.sum(n * n, dim=-1) + torch.sum(n_p * n_p, dim=-1))
    c = (torch.sum(x2 * linalg.matvec_small(Ebar, x1), dim=-1)
         + torch.sum(x2 * E[..., :2, 2], dim=-1)
         + torch.sum(x1 * E[..., 2, :2], dim=-1)
         + E[..., 2, 2])
    d = torch.sqrt(torch.clamp(b * b - a * c, min=0.0))
    denom = b + d
    denom = torch.where(torch.abs(denom) > 1e-30, denom,
                        torch.full_like(denom, 1e-30))
    lam = c / denom
    dx2 = lam[..., None] * n
    dx1 = lam[..., None] * n_p
    n2 = n - linalg.matvec_small(Ebar, dx1)
    n1 = n_p - linalg.matvec_small(EbarT, dx2)
    denom2 = torch.sum(n2 * n2, dim=-1) + torch.sum(n1 * n1, dim=-1)
    denom2 = torch.where(torch.abs(denom2) > 1e-30, denom2,
                         torch.full_like(denom2, 1e-30))
    lam = lam * 2.0 * d / denom2
    dx2 = lam[..., None] * n2
    dx1 = lam[..., None] * n1
    return x1 - dx1, x2 - dx2


def optimal(u1, P1, u2, P2):
    """Optimal (epipolar-corrected) triangulation; DLT on corrected points."""
    F = fundamental_from_P(P1, P2)
    u1c, u2c = _optimal_correct(u1, u2, F)
    return linear_eigen(u1c, P1, u2c, P2)
