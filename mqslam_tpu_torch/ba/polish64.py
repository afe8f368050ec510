"""Float64 final-basin polish for bundle adjustment (dense, exact).

Why this exists: the solver (ba/solver.py) runs everything in float32.
On weakly-constrained monocular chains the LM cost converges to the f32
round-off floor of the summed residuals (~1e-5 relative) while the ATE
valley continues BELOW that floor — measured on the reference's real SVO
dump, f32 LM lands at ATE 0.0227 m where GTSAM's f64 elimination reaches
0.0216 m (results_ate-slam2-BA.txt:2-3). No f32 step acceptance test can
resolve the difference, so the fix is not a better preconditioner but a
higher-precision objective. This module re-evaluates the SAME factors
(ba/factors.py conventions: body-frame chart retraction, SO(3)-log
rotation residuals, Cal3DS2 projection) in float64 and runs a few dense
exact-Schur LM iterations.

Scale: dense Schur is O((6F)^2) memory; SLAM-scale problems (hundreds of
poses, thousands of landmarks) fit trivially. The polish is a finishing
pass — the f32 solver does all the real work; this walks the last
sub-f32-resolution stretch of the valley. Jacobians are central
differences in the chart (h=3e-6, f64: ~1e-12 relative error, well below
what the polish needs).

The JAX package's NumPy module, ported op for op to float64 torch on the
problem's own device (the card in a deployment, the CPU in the tests):
the same factors, chart, step and LM schedule.  A residual and the
central differences of each of its inputs are one evaluation, batched
over the chart steps along a leading dimension; the normal equations are
summed with ``index_add_``, the reduced camera system is one float64
matmul, solved by LU on the free poses (the fixed poses' rows and columns
set to the identity).  The host reads one small tensor an iteration, the
trial cost with the solve's status, which drives the accept / reject
decision, the damping and the stop rule; the start's cost is one more.
"""

import math

import torch

from mqslam_tpu_torch.ba.problem import BAVariables
from mqslam_tpu_torch.utils import profiling

__all__ = ["polish64"]

_H = 3e-6  # central-difference step in the chart
_F64 = torch.float64


# ---------- vectorized f64 SO(3) ----------

def _hat(w):
    """[..., 3] -> the skew matrix [..., 3, 3]."""
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       -1).reshape(w.shape[:-1] + (3, 3))


def _exp(r):
    """Rodrigues: [..., 3] -> [..., 3, 3] (f64)."""
    th = torch.clamp(torch.sqrt((r * r).sum(-1, keepdim=True)), min=1e-300)
    K = _hat(r / th)
    th = th[..., None]
    I = torch.eye(3, dtype=r.dtype, device=r.device)
    R = I + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)
    Ks = _hat(r)
    return torch.where(th < 1e-10, I + Ks + 0.5 * (Ks @ Ks), R)


def _log(R):
    """[..., 3, 3] -> [..., 3] (f64), stable near 0 and pi."""
    tr = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2,
                     -1.0, 1.0)
    th = torch.arccos(tr)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.clamp(2 * torch.sin(th), min=1e-300)
    fac = torch.where(th < 1e-7, 0.5 + th * th / 12, th / s)
    out = fac[..., None] * w
    # near pi the axis comes from the symmetric part
    A = (R + R.transpose(-1, -2)) / 2
    ax = torch.sqrt(torch.clamp((A.diagonal(dim1=-2, dim2=-1) + 1) / 2,
                                min=0))
    sign = torch.sign(w)
    sign = torch.where(sign == 0, 1.0, sign)
    out_pi = th[..., None] * ax * sign
    return torch.where((th > math.pi - 1e-3)[..., None], out_pi, out)


def _retract(p6, d6):
    """(R Exp(dr), c + R dt) — the ba.factors.retract_single chart."""
    R = _exp(p6[..., :3])
    Rn = R @ _exp(d6[..., :3])
    c = p6[..., 3:] + (R @ d6[..., 3:, None])[..., 0]
    return Rn, c


# ---------- f64 residuals (ba/factors.py conventions) ----------

def _obs_res(d6, p6, pts, uv, cal9, inv_sig):
    R, c = _retract(p6, d6)
    Xc = (R.transpose(-1, -2) @ (pts - c)[..., None])[..., 0]
    z = torch.where(Xc[..., 2].abs() > 1e-9, Xc[..., 2], 1e-9)
    x = Xc[..., 0] / z
    y = Xc[..., 1] / z
    fx, fy, sk, u0, v0, k1, k2, t1, t2 = cal9.unbind(-1)
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * k2)
    xd = x * rad + 2 * t1 * x * y + t2 * (r2 + 2 * x * x)
    yd = y * rad + t1 * (r2 + 2 * y * y) + 2 * t2 * x * y
    u = fx * xd + sk * yd + u0
    v = fy * yd + v0
    return (torch.stack([u, v], -1) - uv) * inv_sig[..., None]


def _odo_res(df6, dt6, p6f, p6t, mr, mt, inv_sig6):
    Rf, cf = _retract(p6f, df6)
    Rt, ct = _retract(p6t, dt6)
    Rd = Rf.transpose(-1, -2) @ Rt
    td = (Rf.transpose(-1, -2) @ (ct - cf)[..., None])[..., 0]
    rr = _log(_exp(mr).transpose(-1, -2) @ Rd)
    return torch.cat([rr, td - mt], -1) * inv_sig6


def _pp_res(d6, p6, pr, pt, inv_sig6):
    R, c = _retract(p6, d6)
    rr = _log(_exp(pr).transpose(-1, -2) @ R)
    return torch.cat([rr, c - pt], -1) * inv_sig6


def _steps(device, *sizes):
    """The inputs' deltas of one residual evaluation that gives the
    residual and its central differences in each input: for inputs of
    ``sizes`` (n_1, n_2, ...), one [B, 1, n_i] tensor each, B = 1 + 2 sum
    n_i.  Row 0 is zero; then, input by input, the rows +h e_k and then
    -h e_k (k < n_i), the other inputs at zero."""
    E = torch.eye(sum(sizes), dtype=_F64, device=device) * _H
    rows, lo = [torch.zeros_like(E[:1])], 0
    for n in sizes:
        rows += [E[lo:lo + n], -E[lo:lo + n]]
        lo += n
    return torch.cat(rows)[:, None].split(list(sizes), dim=-1)


def _jacobians(r, *sizes):
    """Residuals [B, N, m] at ``_steps(..., *sizes)`` -> (residual [N, m],
    one central-difference Jacobian [N, m, n_i] an input:
    (r(+h e_k) - r(-h e_k)) / 2h)."""
    out, lo = [], 1
    for n in sizes:
        out.append(((r[lo:lo + n] - r[lo + n:lo + 2 * n])
                    / (2 * _H)).permute(1, 2, 0))
        lo += 2 * n
    return r[0], out


def polish64(problem, v, max_iters: int = 10, lam0: float = 1e-10,
             verbose: bool = False):
    """Polish BAVariables ``v`` for ``problem`` with f64 dense exact-Schur
    LM on the problem's device. Returns (BAVariables f32 on that device,
    history of f64 costs as Python floats).  Span ``ba.polish64`` covers
    the whole, to the last cost read."""
    with profiling.span("ba.polish64", problem.device):
        p6, pts, history = _polish64(problem, v, max_iters, lam0, verbose)
        f32 = lambda x: x.to(torch.float32)
        return BAVariables(pose_r=f32(p6[:, :3]), pose_t=f32(p6[:, 3:]),
                           points=f32(pts)), history


def _polish64(problem, v, max_iters, lam0, verbose):
    """The iterations: (poses [F, 6] (rvec, centre), landmarks [P, 3], both
    float64, and the history)."""
    F = int(problem.n_poses)
    P = int(problem.n_points)
    f64 = lambda x: x.to(_F64)
    inv = lambda valid, sig: torch.where(
        valid, 1.0 / torch.clamp(f64(sig), min=1e-12), 0.0)
    op = problem.obs_pose.long()
    opt = problem.obs_point.long()
    uv = f64(problem.obs_uv)
    cal = f64(problem.calibrations)[problem.obs_cam.long()]
    inv_so = inv(problem.obs_valid, problem.obs_sigma)
    of = problem.odo_from.long()
    ot = problem.odo_to.long()
    mr = f64(problem.odo_r)
    mt = f64(problem.odo_t)
    inv_sq = inv(problem.odo_valid[:, None], problem.odo_sigma)
    ppi = problem.prior_pose_idx.long()
    ppr = f64(problem.prior_pose_r)
    ppt = f64(problem.prior_pose_t)
    inv_sp = inv(problem.prior_pose_valid[:, None], problem.prior_pose_sigma)
    qpi = problem.prior_point_idx.long()
    qpx = f64(problem.prior_point_xyz)
    inv_sqp = inv(problem.prior_point_valid, problem.prior_point_sigma)
    point_valid = problem.point_valid
    mask6 = problem.pose_valid.repeat_interleave(6)

    p6 = torch.cat([f64(v.pose_r), f64(v.pose_t)], 1)
    pts = f64(v.points)

    # the scatter targets of the assembly, in np.add.at's order
    hcc_at = torch.cat([op * F + op, of * F + of, of * F + ot, ot * F + of,
                        ot * F + ot, ppi * F + ppi])
    gc_at = torch.cat([op, of, ot, ppi])
    pt_at = torch.cat([opt, qpi])
    w_at = op * P + opt
    eye3 = torch.eye(3, dtype=_F64, device=p6.device)
    qp_info = (inv_sqp ** 2)[:, None, None] * eye3
    free2 = mask6[:, None] & mask6[None, :]
    eye6f = torch.eye(6 * F, dtype=_F64, device=p6.device)
    zero6 = p6.new_zeros(1, 6)
    d_o, d_x = _steps(p6.device, 6, 3)
    d_qf, d_qt = _steps(p6.device, 6, 6)
    (d_p,) = _steps(p6.device, 6)
    outer = lambda a, b: torch.einsum('okd,oke->ode', a, b)
    grad = lambda a, r: torch.einsum('okd,ok->od', a, r)

    def cost_of(p6c, ptsc):
        r_o = _obs_res(zero6, p6c[op], ptsc[opt], uv, cal, inv_so)
        r_q = _odo_res(zero6, zero6, p6c[of], p6c[ot], mr, mt, inv_sq)
        r_p = _pp_res(zero6, p6c[ppi], ppr, ppt, inv_sp)
        r_qp = (ptsc[qpi] - qpx) * inv_sqp[:, None]
        return 0.5 * ((r_o ** 2).sum() + (r_q ** 2).sum()
                      + (r_p ** 2).sum() + (r_qp ** 2).sum())

    lam = lam0
    cost = cost_of(p6, pts).item()
    history = [cost]
    for it in range(max_iters):
        # residuals + chart Jacobians; the point Jacobian perturbs the
        # point additively
        r_o, (Jc, Jp) = _jacobians(_obs_res(
            d_o, p6[op], pts[opt] + d_x, uv, cal, inv_so), 6, 3)
        r_q, (Jqf, Jqt) = _jacobians(_odo_res(
            d_qf, d_qt, p6[of], p6[ot], mr, mt, inv_sq), 6, 6)
        r_p, (Jpp,) = _jacobians(_pp_res(d_p, p6[ppi], ppr, ppt, inv_sp), 6)
        r_qp = (pts[qpi] - qpx) * inv_sqp[:, None]

        # dense assembly
        Hcc = p6.new_zeros(F * F, 6, 6).index_add_(0, hcc_at, torch.cat([
            outer(Jc, Jc), outer(Jqf, Jqf), outer(Jqf, Jqt), outer(Jqt, Jqf),
            outer(Jqt, Jqt), outer(Jpp, Jpp)]))
        Hcc = Hcc.view(F, F, 6, 6).permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
        Hpp = p6.new_zeros(P, 3, 3).index_add_(
            0, pt_at, torch.cat([outer(Jp, Jp), qp_info]))
        W = p6.new_zeros(F * P, 6, 3).index_add_(0, w_at, outer(Jc, Jp))
        W = W.view(F, P, 6, 3).permute(0, 2, 1, 3).reshape(6 * F, 3 * P)
        g_c = p6.new_zeros(F, 6).index_add_(0, gc_at, torch.cat([
            grad(Jc, r_o), grad(Jqf, r_q), grad(Jqt, r_q), grad(Jpp, r_p)]))
        g_p = p6.new_zeros(P, 3).index_add_(0, pt_at, torch.cat([
            grad(Jp, r_o), r_qp * inv_sqp[:, None]]))

        dHpp = Hpp.diagonal(dim1=-2, dim2=-1)
        point_free = point_valid & (dHpp.sum(-1) > 0)
        Hpp_d = Hpp + (lam * torch.clamp(dHpp, min=1e-12))[..., None] * eye3
        pf3 = point_free[:, None, None]
        Hppi = torch.where(pf3, torch.linalg.inv_ex(
            torch.where(pf3, Hpp_d, eye3))[0], 0.0)

        dHcc = Hcc.diagonal()
        dHcc += lam * torch.clamp(dHcc, min=1e-12)
        WH = torch.einsum('fpe,pec->fpc', W.view(6 * F, P, 3),
                          Hppi).reshape(6 * F, 3 * P)
        S = Hcc - WH @ W.T
        b = -g_c.reshape(-1) + WH @ g_p.reshape(-1)
        # the fixed poses' rows and columns set to the identity: the free
        # block's LU without a host read of the mask
        x, info = torch.linalg.solve_ex(torch.where(free2, S, eye6f),
                                        torch.where(mask6, b, 0.0))
        dc = torch.where(mask6, x, 0.0)
        dpv = torch.einsum('pec,pc->pe', -Hppi, g_p + (dc @ W).view(P, 3))
        dpv = torch.where(point_free[:, None], dpv, 0.0)

        Rn, cn = _retract(p6, dc.view(F, 6))
        p6_try = torch.cat([_log(Rn), cn], 1)
        pts_try = pts + dpv
        # the iteration's one read: the trial cost and the solve's status
        nc, failed = torch.stack([cost_of(p6_try, pts_try),
                                  info.to(_F64)]).tolist()
        if failed:
            break
        if verbose:
            print(f"polish64 iter {it}: cost {cost:.9e} -> {nc:.9e} "
                  f"lam {lam:.1e}")
        if nc < cost:
            p6, pts, cost = p6_try, pts_try, nc
            lam = max(lam / 4, 1e-12)
        else:
            lam = min(lam * 10, 1e3)
            if lam >= 1e3:
                break
        history.append(cost)
        if len(history) > 2 and history[-2] - history[-1] < 1e-12 * max(
                history[-2], 1e-30):
            break

    return p6, pts, history
