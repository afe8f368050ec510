"""Batched two-view triangulation.

The four methods of the JAX package: ``linear_eigen`` (homogeneous DLT,
smallest eigenvector of A^T A), ``linear_ls`` (inhomogeneous 4x3 least
squares through the symmetric 3x3 normal equations), ``iterative_ls``
(Hartley-Sturm depth re-weighting, at most 10 solves, converged points
frozen) and ``optimal`` (Lindstrom's closed-form two-step epipolar
correction, "Triangulation Made Easy", CVPR 2010, followed by the DLT).  The
keyframe phase of the front-end uses ``optimal``.

Inputs are normalized image coordinates ``u1, u2: [..., N, 2]`` and camera
matrices ``P1, P2: [..., 3+, 4]`` whose batch dims match the points' batch
dims without the N axis (only the first 3 rows are used, so 4x4 extrinsics
work directly).  Status: ``linear_eigen`` / ``optimal`` bool, False for
non-finite / huge points; ``linear_ls`` bool, always True; ``iterative_ls``
int32 in {1, 0, -1, -2, -3} (converged and in front / not converged /
behind the first camera / behind the second / behind both).
"""

import torch

from mqslam_tpu_torch.ops import linalg

__all__ = ["linear_eigen", "linear_ls", "iterative_ls", "optimal",
           "polynomial", "METHODS", "fundamental_from_P"]


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


def _normal_eq(A1, b1, A2, b2, w1, w2):
    """Weighted normal equations from two cameras' 2x3 row blocks:
    N = sum_k w_k^2 A_k^T A_k (3x3), rhs = sum_k w_k^2 A_k^T b_k."""
    w1sq = (w1 * w1)[..., None, None]
    w2sq = (w2 * w2)[..., None, None]
    N = linalg.gram(A1) * w1sq + linalg.gram(A2) * w2sq
    rhs = (linalg.gram_rhs(A1, b1) * w1sq[..., 0]
           + linalg.gram_rhs(A2, b2) * w2sq[..., 0])
    return N, rhs


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


def linear_ls(u1, P1, u2, P2):
    """Inhomogeneous linear LS (4 equations, 3 unknowns) per point, by the
    symmetric 3x3 normal equations and their pseudo-inverse."""
    A1, b1 = _rows(u1, _prep(P1))
    A2, b2 = _rows(u2, _prep(P2))
    one = torch.ones(u1.shape[:-1], dtype=u1.dtype, device=u1.device)
    N, rhs = _normal_eq(A1, b1, A2, b2, one, one)
    x = linalg.pinv_solve_sym(N, rhs)
    shape = torch.broadcast_shapes(u1.shape[:-1], x.shape[:-1])
    return x, torch.ones(shape, dtype=torch.bool, device=u1.device)


def iterative_ls(u1, P1, u2, P2, tolerance=3e-5, iterations: int = 10):
    """Hartley-Sturm iterative LS with cumulative depth re-weighting: each
    non-converged iteration multiplies each camera's rows by 1/d_new,
    convergence is |d_new - d| <= tolerance (plus a dtype-aware relative
    term: float32's normal-equation roundoff floor is ~1e-4 relative) on
    both depths; at most ``iterations`` solves, converged points frozen."""
    P1p = _prep(P1)
    P2p = _prep(P2)
    A1, b1 = _rows(u1, P1p)
    A2, b2 = _rows(u2, P2p)
    n_batch = torch.broadcast_shapes(u1.shape[:-1], A1.shape[:-2])
    like = dict(dtype=u1.dtype, device=u1.device)
    x = torch.zeros(n_batch + (3,), **like)
    d1 = torch.ones(n_batch, **like)
    d2 = torch.ones(n_batch, **like)
    w1 = torch.ones(n_batch, **like)
    w2 = torch.ones(n_batch, **like)
    conv = torch.zeros(n_batch, dtype=torch.bool, device=u1.device)
    eps_rel = 2048.0 * torch.finfo(u1.dtype).eps
    tiny = lambda d: torch.where(torch.abs(d) > 1e-30, d,
                                 torch.full_like(d, 1e-30))
    for _ in range(iterations):
        N, rhs = _normal_eq(A1, b1, A2, b2, w1, w2)
        x_new = linalg.pinv_solve_sym(N, rhs)
        x = torch.where(conv[..., None], x, x_new)
        d1_new = torch.where(conv, d1, _depth(P1p, x))
        d2_new = torch.where(conv, d2, _depth(P2p, x))
        tol1 = tolerance + eps_rel * torch.abs(d1_new)
        tol2 = tolerance + eps_rel * torch.abs(d2_new)
        conv_now = (torch.abs(d1_new - d1) <= tol1) \
            & (torch.abs(d2_new - d2) <= tol2)
        conv = conv | conv_now
        upd = ~conv
        w1 = torch.where(upd, w1 / tiny(d1_new), w1)
        w2 = torch.where(upd, w2 / tiny(d2_new), w2)
        # a common row scale does not change the solution: renormalize so
        # the cumulative products neither underflow nor overflow in float32
        scale = torch.clamp(torch.maximum(torch.abs(w1), torch.abs(w2)),
                            min=1e-30)
        w1 = w1 / scale
        w2 = w2 / scale
        d1, d2 = d1_new, d2_new
    front1 = d1 > 0
    front2 = d2 > 0
    status = (conv & front1 & front2).to(torch.int32)
    status = status - (~front1).to(torch.int32)
    status = status - 2 * (~front2).to(torch.int32)
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


# Reference-compatible name: the reference calls this method "polynomial".
polynomial = optimal

METHODS = {
    "linear_eigen": linear_eigen,
    "linear_ls": linear_ls,
    "iterative_ls": iterative_ls,
    "polynomial": optimal,
}
