"""Two-view epipolar geometry: F estimation + essential decomposition.

The math behind the reference's stereo pose-estimation lab
(reference: Work/calibration/application/calibrate.py:60-503
triangl_pose_est_interactive): RANSAC fundamental with Snavely's
0.006*max(size) threshold (:266-283), 8-point refit on inliers (:287),
E = F in normalized coordinates (:293), the HZ 9.19 (R, t) extraction
(:295-310), and the 4-way twisted-pair/baseline disambiguation via
triangulated-cheirality voting (:316-381).
"""

import numpy as np
import torch

from mqslam_tpu_torch.ops import linalg, triangulation as tri

__all__ = ["fundamental_8point", "fundamental_ransac",
           "decompose_essential", "relative_pose_from_fundamental"]

_SQRT2 = float(np.float32(np.sqrt(2.0)))   # jnp.sqrt(2.0): a float32


def _normalize(pts, w):
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / n[..., None]
    centered = pts - mean
    dist = torch.sqrt(torch.sum(centered ** 2, dim=-1))
    md = torch.sum(dist * w, dim=-1, keepdim=True) / n
    s = _SQRT2 / torch.clamp(md, min=1e-12)
    return centered * s[..., None], mean[..., 0, :], s[..., 0]


def fundamental_8point(pts1, pts2, valid=None):
    """Normalized 8-point fundamental matrix (LS over all valid matches,
    rank-2 enforced). pts [..., K, 2] -> F [..., 3, 3] with x2^T F x1 = 0."""
    if valid is None:
        valid = torch.ones(pts1.shape[:-1], dtype=torch.bool,
                           device=pts1.device)
    w = valid.to(pts1.dtype)
    p1, m1, s1 = _normalize(pts1, w)
    p2, m2, s2 = _normalize(pts2, w)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    rows = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                        x1, y1, one], dim=-1) * w[..., None]
    S = linalg.gram(rows)
    _, V = linalg.eigh_jacobi(S, sweeps=10)
    f = V[..., :, 0]
    Fn = f.reshape(f.shape[:-1] + (3, 3))
    # rank-2 enforcement: zero the smallest singular value
    Fn = _project_rank2(Fn)
    # denormalize: F = T2^T Fn T1
    T1 = _similarity(m1, s1)
    T2 = _similarity(m2, s2)
    F = linalg.matmul_small(T2.transpose(-1, -2),
                            linalg.matmul_small(Fn, T1))
    norm = torch.sqrt(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / torch.clamp(norm, min=1e-30)


def _similarity(mean, s):
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
        torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _project_rank2(F):
    """Nearest rank-2 matrix: subtract smallest singular triplet."""
    FtF = linalg.gram(F)
    _, V = linalg.eigh_jacobi(FtF, sweeps=10)
    v0 = V[..., :, 0]                      # right vector of smallest sv
    Fv = linalg.matvec_small(F, v0)
    return F - Fv[..., :, None] * v0[..., None, :]


def _sampson_sq(F, pts1, pts2):
    """Squared Sampson distance per match."""
    x1 = torch.cat([pts1, torch.ones_like(pts1[..., :1])], dim=-1)
    x2 = torch.cat([pts2, torch.ones_like(pts2[..., :1])], dim=-1)
    Fx1 = torch.sum(F[..., None, :, :] * x1[..., None, :], dim=-1)
    Ftx2 = torch.sum(F.transpose(-1, -2)[..., None, :, :]
                     * x2[..., None, :], dim=-1)
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-30)


def fundamental_ransac(pts1, pts2, valid=None, threshold=1.0,
                       n_hyp: int = 256, scores=None, generator=None):
    """Batched-hypothesis RANSAC F: 8-point minimal sets scored by Sampson
    distance; final 8-point refit on the winning inlier set.

    ``threshold`` in the units of pts (the reference uses
    0.006 * max(image size) pixels, calibrate.py:266-283 citing Snavely).
    The minimal sets come from ``scores`` [n_hyp, K], uniform draws in
    [0, 1): hypothesis h takes the 8 valid matches with the smallest
    scores.  When ``scores`` is None they are drawn from ``generator`` (a
    ``torch.Generator`` on the points' device).  Ties among the inlier
    counts go to the first hypothesis.  Returns (F, inlier_mask,
    n_inliers)."""
    K = pts1.shape[0]
    if valid is None:
        valid = torch.ones(K, dtype=torch.bool, device=pts1.device)
    if scores is None:
        scores = torch.rand((n_hyp, K), generator=generator,
                            device=pts1.device)
    scores = scores.to(pts1.dtype) + (1.0 - valid.to(pts1.dtype)) * 10.0
    sel = torch.argsort(scores, dim=1, stable=True)[:, :8]
    F_h = fundamental_8point(pts1[sel], pts2[sel])
    d2 = _sampson_sq(F_h, pts1[None], pts2[None])
    inl = (d2 < threshold ** 2) & valid[None]
    n_inl = torch.sum(inl, dim=1)
    best = torch.argmax(n_inl)
    inlier = inl[best]
    use = torch.where(torch.sum(inlier) >= 8, inlier, valid)
    F = fundamental_8point(pts1, pts2, use)
    d2f = _sampson_sq(F, pts1, pts2)
    inlier = (d2f < threshold ** 2) & valid
    return F, inlier, torch.sum(inlier)


def decompose_essential(E):
    """HZ 9.19: E -> (R1, R2, t) candidate factors (4 poses: (R1, +-t),
    (R2, +-t)); calibrate.py:295-310."""
    # E's two large singular values are EQUAL, so diagonalizing E E^T and
    # E^T E independently picks uncoupled bases in the degenerate subspace:
    # u_i must come from E v_i / |E v_i| to keep E = U diag V^T consistent.
    EtE = linalg.gram(E)
    _, V = linalg.eigh_jacobi(EtE, sweeps=10)
    V = torch.flip(V, (-1,))  # descending: v1, v2 span the row space
    detV = torch.linalg.det(V)
    V = V * torch.stack([torch.ones_like(detV), torch.ones_like(detV),
                         detV], dim=-1)[..., None, :]
    Ev1 = linalg.matvec_small(E, V[..., :, 0])
    Ev2 = linalg.matvec_small(E, V[..., :, 1])
    u1 = Ev1 / torch.clamp(torch.linalg.norm(Ev1, dim=-1, keepdim=True),
                           min=1e-30)
    u2 = Ev2 / torch.clamp(torch.linalg.norm(Ev2, dim=-1, keepdim=True),
                           min=1e-30)
    u3 = torch.linalg.cross(u1, u2)
    U = torch.stack([u1, u2, u3], dim=-1)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Vt = V.transpose(-1, -2)
    R1 = linalg.matmul_small(U, linalg.matmul_small(W, Vt))
    R2 = linalg.matmul_small(U, linalg.matmul_small(W.T, Vt))
    t = U[..., :, 2]
    return R1, R2, t


def relative_pose_from_fundamental(F, pts1_norm, pts2_norm, valid=None):
    """Pick the (R, t) among the 4 essential factorizations that places the
    most triangulated points in front of both cameras (the reference's
    chirality disambiguation, calibrate.py:316-381). Points must be
    normalized coordinates (E = F there, calibrate.py:293).  Ties go to the
    first candidate.

    Returns (R, t, n_in_front) with |t| = 1."""
    if valid is None:
        valid = torch.ones(pts1_norm.shape[0], dtype=torch.bool,
                           device=F.device)
    R1, R2, t = decompose_essential(F)
    eye34 = torch.cat([torch.eye(3, dtype=F.dtype, device=F.device),
                       torch.zeros((3, 1), dtype=F.dtype, device=F.device)],
                      dim=1)

    def count_front(R, tt):
        P2 = torch.cat([R, tt[:, None]], dim=1)
        x, _ = tri.linear_ls(pts1_norm, eye34, pts2_norm, P2)
        z1 = x[:, 2]
        z2 = torch.sum(R[2] * x, dim=-1) + tt[2]
        return torch.sum((z1 > 0) & (z2 > 0) & valid)

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    counts = torch.stack([count_front(R, tt) for (R, tt) in cands])
    best = torch.argmax(counts)
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return Rs[best], ts[best], counts[best]
