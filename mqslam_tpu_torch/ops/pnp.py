"""Perspective-n-Point: batched DLT + Gauss-Newton refinement + RANSAC.

Replaces ``cv2.solvePnP`` / ``cv2.solvePnPRansac`` in the front-end's pose
ladder: RANSAC with a 2 px reprojection threshold, then iterative refinement
on the inliers from the extrinsic guess.

RANSAC evaluates a fixed batch of hypotheses concurrently (12x12 DLT null
space + polar extraction + inlier scoring); the refinement is a
fixed-iteration damped Gauss-Newton with a closed-form 6x6 solve and an
analytic Jacobian; all point sets are fixed-capacity tensors with validity
masks.  Every function takes leading batch dims.
"""

import torch

from mqslam_tpu_torch.core import camera as cam_mod, se3, so3
from mqslam_tpu_torch.ops import homography as homog, linalg

__all__ = ["pnp_dlt", "pnp_planar", "pnp_solve", "pnp_refine",
           "ransac_draw", "pnp_ransac", "reprojection_error"]


def _polar_rotation(M):
    """Polar factor of [..., 3, 3] M: R = M V S^-1 V^T, M^T M = V S^2 V^T."""
    w3, V3 = linalg.eigh_jacobi(linalg.gram(M), sweeps=8)
    s_inv = 1.0 / torch.sqrt(torch.clamp(w3, min=1e-20))
    VsV = linalg.matmul_small(V3 * s_inv[..., None, :], V3.transpose(-1, -2))
    return linalg.matmul_small(M, VsV)


def pnp_dlt(objp, uv_norm, weights=None):
    """Direct linear transform pose from >= 6 2D(normalized)-3D pairs.

    objp [..., K, 3], uv_norm [..., K, 2], optional weights [..., K] (0 or 1
    rows). Returns (R [..., 3, 3], t [..., 3]) — cheirality-corrected,
    polar-projected onto SO(3)."""
    X, Y, Z = objp[..., 0], objp[..., 1], objp[..., 2]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    row_x = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                         -x * X, -x * Y, -x * Z, -x], dim=-1)
    row_y = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                         -y * X, -y * Y, -y * Z, -y], dim=-1)
    rows = torch.cat([row_x, row_y], dim=-2)  # [..., 2K, 12]
    if weights is not None:
        w2 = torch.cat([weights, weights], dim=-1)[..., None]
        rows = rows * w2
    S = linalg.gram(rows)  # [..., 12, 12]
    # null space by shifted inverse iteration — minimal RANSAC sets make S
    # exactly singular, so this converges in one solve
    p = linalg.smallest_eigvec_spd(S, iters=3)  # [..., 12]
    M = p.reshape(p.shape[:-1] + (3, 4))

    Mr = M[..., :3]
    det = (Mr[..., 0, 0] * (Mr[..., 1, 1] * Mr[..., 2, 2]
                            - Mr[..., 1, 2] * Mr[..., 2, 1])
           - Mr[..., 0, 1] * (Mr[..., 1, 0] * Mr[..., 2, 2]
                              - Mr[..., 1, 2] * Mr[..., 2, 0])
           + Mr[..., 0, 2] * (Mr[..., 1, 0] * Mr[..., 2, 1]
                              - Mr[..., 1, 1] * Mr[..., 2, 0]))
    sign = torch.where(det >= 0, 1.0, -1.0)[..., None, None]
    M = M * sign
    scale = torch.pow(torch.clamp(torch.abs(det), min=1e-30),
                      1.0 / 3.0)[..., None, None]
    Mn = M / scale
    R = _polar_rotation(Mn[..., :3])
    t = Mn[..., 3]
    return R, t


def pnp_planar(objp, uv_norm, weights=None):
    """Homography-decomposition pose for (near-)coplanar 3D points.

    The 12-parameter DLT is rank-deficient when the scene is a plane — the
    bootstrap regime.  IPPE-style alternative: fit the best plane (principal
    axes), fit the plane->image homography, decompose
    H ~ [sR e1, sR e2, s(R O + t)].  Returns (R [..., 3, 3], t [..., 3])."""
    if weights is None:
        weights = torch.ones(objp.shape[:-1], dtype=objp.dtype,
                             device=objp.device)
    w = weights[..., None]
    n = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1.0)
    O = torch.sum(objp * w, dim=-2) / n  # plane origin (centroid)
    centered = (objp - O[..., None, :]) * w
    C = torch.sum(centered[..., :, None] * centered[..., None, :], dim=-3)
    _, V = linalg.eigh_jacobi(C, sweeps=8)
    e1 = V[..., :, 2]  # largest-variance axes span the plane
    e2 = V[..., :, 1]
    pu = torch.sum((objp - O[..., None, :]) * e1[..., None, :], dim=-1)
    pv = torch.sum((objp - O[..., None, :]) * e2[..., None, :], dim=-1)
    plane_uv = torch.stack([pu, pv], dim=-1)
    H = homog.fit_homography(plane_uv, uv_norm, weights > 0)
    a1 = H[..., :, 0]
    a2 = H[..., :, 1]
    b = H[..., :, 2]
    s = torch.sqrt(torch.clamp(
        torch.linalg.vector_norm(a1, dim=-1)
        * torch.linalg.vector_norm(a2, dim=-1), min=1e-30))
    # sign: centroid must be in front of the camera (depth b_z / s > 0)
    sign = torch.where(b[..., 2] >= 0, 1.0, -1.0)[..., None]
    a1 = a1 * sign / s[..., None]
    a2 = a2 * sign / s[..., None]
    b = b * sign / s[..., None]
    r3 = torch.linalg.cross(a1, a2, dim=-1)
    M = torch.stack([a1, a2, r3], dim=-1)  # columns
    Rm = _polar_rotation(M)
    A = torch.stack([Rm[..., :, 0], Rm[..., :, 1],
                     torch.linalg.cross(Rm[..., :, 0], Rm[..., :, 1],
                                        dim=-1)], dim=-1)
    # A maps PLANE-BASIS coords (pu, pv, n) to camera coords; the world->cam
    # rotation needs the plane-basis change rolled in: R = A E^T with
    # E = [e1 e2 e1xe2]
    E = torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], dim=-1)
    R = linalg.matmul_small(A, E.transpose(-1, -2))
    t = b - linalg.matvec_small(R, O)
    return R, t


def _pose_cost_norm(R, t, objp, uv_norm, weights):
    """Masked sum of squared normalized-image residuals for a pose."""
    pc = linalg.matvec_small(R[..., None, :, :], objp) + t[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) > 1e-12, pc[..., 2],
                    torch.full_like(pc[..., 2], 1e-12))
    proj = pc[..., :2] / z[..., None]
    r2 = torch.sum((proj - uv_norm) ** 2, dim=-1)
    r2 = torch.where(pc[..., 2] > 0, r2, torch.full_like(r2, 1e6))
    return torch.sum(r2 * weights, dim=-1)


def pnp_solve(objp, uv_norm, weights=None):
    """General minimal / least-squares pose: best of the DLT and the
    planar-homography solutions by reprojection cost (handles generic and
    coplanar scenes branchlessly)."""
    if weights is None:
        weights = torch.ones(objp.shape[:-1], dtype=objp.dtype,
                             device=objp.device)
    R1, t1 = pnp_dlt(objp, uv_norm, weights)
    R2, t2 = pnp_planar(objp, uv_norm, weights)
    c1 = _pose_cost_norm(R1, t1, objp, uv_norm, weights)
    c2 = _pose_cost_norm(R2, t2, objp, uv_norm, weights)
    pick2 = (c2 < c1)[..., None, None]
    R = torch.where(pick2, R2, R1)
    t = torch.where(pick2[..., 0], t2, t1)
    return R, t


def _project(objp, rvec, tvec, cal):
    """(pixels [..., K, 2], depth [..., K]) of objp [..., K, 3] under poses
    [..., 3] (one pose per point set)."""
    P = se3.from_rvec_tvec(rvec, tvec)
    return cam_mod.project(objp, P[..., None, :, :], cal)


def reprojection_error(objp, uv_px, cal, rvec, tvec, valid=None):
    """RMS pixel reprojection error [...] + per-point reprojections."""
    proj, _ = _project(objp, rvec, tvec, cal)
    d2 = torch.sum((proj - uv_px) ** 2, dim=-1)
    if valid is not None:
        n = torch.clamp(torch.sum(valid, dim=-1), min=1)
        rms = torch.sqrt(torch.sum(
            torch.where(valid, d2, torch.zeros_like(d2)), dim=-1) / n)
    else:
        rms = torch.sqrt(torch.mean(d2, dim=-1))
    return rms, proj


def _so3_exp_jac(rvec):
    """R = exp(rvec) [..., 3, 3] and dR/drvec [..., 3, 3, 3(k)] — the
    forward-mode derivative of ``so3.exp`` as written there (same guarded
    coefficients, both branches of its near-zero switch)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    tc = torch.clamp(theta2, min=1e-12)
    theta = torch.sqrt(tc)
    small = theta2 < 1e-10
    sin, cos = torch.sin(theta), torch.cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / tc)
    # d/d(theta2); the clamp passes no derivative below its floor, where the
    # series branch is the one selected anyway
    dth = 0.5 / theta
    da = torch.where(small, torch.full_like(a, -1.0 / 6.0),
                     (cos * theta - sin) / tc * dth)
    db = torch.where(small, torch.full_like(b, -1.0 / 24.0),
                     (sin * dth * tc - (1.0 - cos)) / (tc * tc))
    K = so3.hat(rvec)
    K2 = linalg.matmul_small(K, K)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + a[..., None, None] * K + b[..., None, None] * K2
    dK = so3.hat(eye)                                   # [3(k), 3, 3]
    dK2 = linalg.matmul_small(dK, K[..., None, :, :]) \
        + linalg.matmul_small(K[..., None, :, :], dK)   # [..., 3(k), 3, 3]
    dt2 = 2.0 * rvec                                    # d theta2 / d r_k
    dR = ((da[..., None] * dt2)[..., None, None] * K[..., None, :, :]
          + a[..., None, None, None] * dK
          + (db[..., None] * dt2)[..., None, None] * K2[..., None, :, :]
          + b[..., None, None, None] * dK2)             # [..., k, 3, 3]
    return R, dR.movedim(-3, -1)


def _residual_jac(params, objp, uv_px, cal):
    """Reprojection residual [..., 2K] and its Jacobian [..., 2K, 6] wrt
    (rvec, tvec), through the Cal3DS2 distortion — the analytic counterpart
    of forward-mode differentiation of ``camera.project``."""
    rvec, tvec = params[..., :3], params[..., 3:]
    R, dR = _so3_exp_jac(rvec)                        # [...,3,3], [...,3,3,3]
    pc = linalg.matvec_small(R[..., None, :, :], objp) + tvec[..., None, :]
    # d pc / d rvec_k = dR_k X ; d pc / d tvec = I        -> [..., K, 3, 6]
    dpc_r = torch.sum(dR[..., None, :, :, :] * objp[..., None, :, None],
                      dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device)
    dpc = torch.cat([dpc_r, eye.expand(dpc_r.shape)], dim=-1)
    z = pc[..., 2]
    big = torch.abs(z) > 1e-12
    zs = torch.where(big, z, torch.full_like(z, 1e-12))
    x = pc[..., 0] / zs
    y = pc[..., 1] / zs
    dzs = torch.where(big[..., None], dpc[..., 2, :],
                      torch.zeros_like(dpc[..., 2, :]))
    dx = (dpc[..., 0, :] - x[..., None] * dzs) / zs[..., None]   # [..., K, 6]
    dy = (dpc[..., 1, :] - y[..., None] * dzs) / zs[..., None]
    # distortion
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cal.k1 + r2 * cal.k2)
    xd = x * radial + 2.0 * cal.p1 * x * y + cal.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cal.p1 * (r2 + 2.0 * y * y) + 2.0 * cal.p2 * x * y
    x_, y_ = x[..., None], y[..., None]
    dr2 = 2.0 * (x_ * dx + y_ * dy)
    drad = (cal.k1 + 2.0 * r2 * cal.k2)[..., None] * dr2
    dxy = dx * y_ + x_ * dy
    dxd = (dx * radial[..., None] + x_ * drad + 2.0 * cal.p1 * dxy
           + cal.p2 * (dr2 + 4.0 * x_ * dx))
    dyd = (dy * radial[..., None] + y_ * drad
           + cal.p1 * (dr2 + 4.0 * y_ * dy) + 2.0 * cal.p2 * dxy)
    u = cal.fx * xd + cal.s * yd + cal.u0
    v = cal.fy * yd + cal.v0
    du = cal.fx * dxd + cal.s * dyd
    dv = cal.fy * dyd
    res = torch.stack([u, v], dim=-1) - uv_px                    # [..., K, 2]
    J = torch.stack([du, dv], dim=-2)                            # [.., K, 2, 6]
    lead = res.shape[:-2]
    return res.reshape(lead + (-1,)), J.reshape(lead + (-1, 6))


def pnp_refine(objp, uv_px, cal, rvec0, tvec0, valid=None, iters: int = 10,
               damping: float = 1e-6):
    """Levenberg-style Gauss-Newton pose refinement from an extrinsic guess
    (cv2.solvePnP iterative with useExtrinsicGuess=True).

    objp [..., K, 3], uv_px [..., K, 2], valid [..., K], rvec0/tvec0
    [..., 3]; fixed ``iters`` damped GN steps."""
    if valid is None:
        valid = torch.ones(objp.shape[:-1], dtype=torch.bool,
                           device=objp.device)
    w = valid.to(objp.dtype)
    # invalid slots may carry NaN (never-initialised tracker slots);
    # multiplying by 0 does NOT absorb NaN — zero them first
    objp = torch.where(valid[..., None], objp, torch.zeros_like(objp))
    uv_px = torch.where(valid[..., None], uv_px, torch.zeros_like(uv_px))
    wr = torch.repeat_interleave(w, 2, dim=-1)                   # [..., 2K]
    eye6 = torch.eye(6, dtype=objp.dtype, device=objp.device)

    params = torch.cat([rvec0, tvec0], dim=-1)
    for _ in range(iters):
        r, J = _residual_jac(params, objp, uv_px, cal)
        Jw = J * wr[..., None]
        rw = r * wr
        JtJ = linalg.gram(Jw)
        Jtr = linalg.gram_rhs(Jw, rw)
        dmax = torch.diagonal(JtJ, dim1=-2, dim2=-1).amax(dim=-1)
        # Levenberg damping keeps JtJ SPD, so the closed-form blocked solve
        # applies
        lam = damping * torch.clamp(dmax, min=1.0)
        JtJ = JtJ + (lam + 1e-12 * dmax)[..., None, None] * eye6
        params = params + linalg.solve6x6_spd(JtJ, -Jtr)
    return params[..., :3], params[..., 3:]


def ransac_draw(B, n_hyp, K, dtype, device, generator):
    """``pnp_ransac``'s draw for ``B`` problems of ``K`` points: ``scores``
    [B, n_hyp, K], uniform in [0, 1), from ``generator``.  Made by a caller
    and handed in, it gives the result of ``pnp_ransac`` drawing from the
    same generator and leaves the generator in the same state."""
    return torch.rand((B, n_hyp, K), dtype=dtype, device=device,
                      generator=generator)


def pnp_ransac(objp, uv_px, cal, valid, scores=None, generator=None,
               n_hyp: int = 128, sample_size: int = 6,
               reproj_threshold: float = 2.0, refine_iters: int = 5):
    """Batched-hypothesis RANSAC PnP.

    objp [..., K, 3], uv_px [..., K, 2], valid [..., K] bool. All ``n_hyp``
    minimal-set hypotheses are solved and scored concurrently (fixed work,
    no adaptive early exit).

    The minimal sets come from ``scores`` [..., n_hyp, K], uniform draws in
    [0, 1): hypothesis h takes the ``sample_size`` valid points with the
    smallest scores.  When ``scores`` is None they are drawn from
    ``generator`` (a ``torch.Generator`` on the tensors' device) by
    ``ransac_draw``.

    Returns (rvec, tvec, inlier_mask [..., K], n_inliers). The winning
    hypothesis is GN-refined on its inlier set."""
    lead = objp.shape[:-2]
    K = objp.shape[-2]
    dt = objp.dtype
    dev = objp.device
    objp = objp.reshape((-1, K, 3))
    uv_px = uv_px.reshape((-1, K, 2))
    valid = valid.reshape((-1, K))
    B = objp.shape[0]
    # NaN in invalid slots would poison hypothesis scoring and the refine
    objp = torch.where(valid[..., None], objp, torch.zeros_like(objp))
    uv_px = torch.where(valid[..., None], uv_px, torch.zeros_like(uv_px))

    # Random valid minimal sets: invalid points pushed to the end, take the
    # first `sample_size` after a stable argsort.
    if scores is None:
        scores = ransac_draw(B, n_hyp, K, dt, dev, generator)
    scores = scores.reshape((B, -1, K)).to(dt)
    scores = scores + (1.0 - valid.to(dt))[:, None, :] * 10.0
    sel = torch.argsort(scores, dim=-1, stable=True)[..., :sample_size]
    bidx = torch.arange(B, device=dev)[:, None, None]
    objp_sets = objp[bidx, sel]          # [B, n_hyp, S, 3]
    uv_sets = uv_px[bidx, sel]           # [B, n_hyp, S, 2]

    uvn_sets = cam_mod.undistort_points(uv_sets, cal)
    R, t = pnp_solve(objp_sets, uvn_sets)  # [B, n_hyp, 3, 3], [B, n_hyp, 3]

    # Score every hypothesis against all points (pixel reprojection).
    P = se3.from_R_t(R, t)  # [B, n_hyp, 4, 4]
    proj, depth = cam_mod.project(objp[:, None, :, :], P[:, :, None], cal)
    err2 = torch.sum((proj - uv_px[:, None]) ** 2, dim=-1)
    inl = (err2 < reproj_threshold ** 2) & valid[:, None, :] & (depth > 0)
    n_inl = torch.sum(inl, dim=-1)
    best = torch.argmax(n_inl, dim=-1)   # first maximum
    b1 = torch.arange(B, device=dev)

    rvec0 = so3.log(R[b1, best])
    tvec0 = t[b1, best]
    inlier_mask = inl[b1, best]
    # Refine on the winning inlier set (fall back to all valid points if the
    # inlier set is degenerate — the caller gates on n_inliers anyway).
    use = torch.where((torch.sum(inlier_mask, dim=-1) >= sample_size)[:, None],
                      inlier_mask, valid)
    rvec, tvec = pnp_refine(objp, uv_px, cal, rvec0, tvec0, valid=use,
                            iters=refine_iters)

    def recount(rv, tv):
        proj_r, depth_r = _project(objp, rv, tv, cal)
        err2_r = torch.sum((proj_r - uv_px) ** 2, dim=-1)
        return (err2_r < reproj_threshold ** 2) & valid & (depth_r > 0)

    # Expand-and-re-refine: a minimal-set hypothesis is rough (its 2 px band
    # captures only part of the true inlier set), so recount at the refined
    # pose and refine again on the grown set.
    grown = recount(rvec, tvec)
    use2 = torch.where((torch.sum(grown, dim=-1) >= sample_size)[:, None],
                       grown, use)
    rvec, tvec = pnp_refine(objp, uv_px, cal, rvec, tvec, valid=use2,
                            iters=refine_iters)
    inlier_mask = recount(rvec, tvec)    # inliers of the final model
    return (rvec.reshape(lead + (3,)), tvec.reshape(lead + (3,)),
            inlier_mask.reshape(lead + (K,)),
            torch.sum(inlier_mask, dim=-1).reshape(lead))
