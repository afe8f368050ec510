"""Float64 final-basin polish for bundle adjustment (host, dense, exact).

Why this exists: the solver (ba/solver.py) runs everything in float32.
On weakly-constrained monocular chains the LM cost converges to the f32
round-off floor of the summed residuals (~1e-5 relative) while the ATE
valley continues BELOW that floor — measured on the reference's real SVO
dump, f32 LM lands at ATE 0.0227 m where GTSAM's f64 elimination reaches
0.0216 m (results_ate-slam2-BA.txt:2-3). No f32 step acceptance test can
resolve the difference, so the fix is not a better preconditioner but a
higher-precision objective. This module re-evaluates the SAME factors
(ba/factors.py conventions: body-frame chart retraction, SO(3)-log
rotation residuals, Cal3DS2 projection) in numpy float64 and runs a few
dense exact-Schur LM iterations on the host.

Scale: dense Schur is O((6F)^2) memory; SLAM-scale problems (hundreds of
poses, thousands of landmarks) fit trivially. The polish is a finishing
pass — the f32 TPU solver does all the real work; this walks the last
sub-f32-resolution stretch of the valley. Jacobians are central
differences in the chart (h=3e-6, f64: ~1e-12 relative error, well below
what the polish needs).

A copy of the JAX package's module, NumPy on the host: it takes the port's
BAProblem / BAVariables, reads their tensors back to the host, and returns
float32 BAVariables on the problem's device.
"""

import numpy as np
import torch

from mqslam_tpu_torch.ba.problem import BAVariables
from mqslam_tpu_torch.utils import profiling

__all__ = ["polish64"]

_H = 3e-6  # central-difference step in the chart


# ---------- vectorized f64 SO(3) ----------

def _exp(r):
    """Rodrigues: [..., 3] -> [..., 3, 3] (f64)."""
    r = np.asarray(r, np.float64)
    th = np.linalg.norm(r, axis=-1, keepdims=True)
    th = np.maximum(th, 1e-300)
    k = r / th
    th = th[..., None]
    K = np.zeros(r.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    I = np.broadcast_to(np.eye(3), K.shape)
    s, c = np.sin(th), np.cos(th)
    R = I + s * K + (1 - c) * (K @ K)
    small = th[..., 0, 0] < 1e-10
    if np.any(small):
        Ks = np.zeros_like(K)
        rs = r
        Ks[..., 0, 1], Ks[..., 0, 2] = -rs[..., 2], rs[..., 1]
        Ks[..., 1, 0], Ks[..., 1, 2] = rs[..., 2], -rs[..., 0]
        Ks[..., 2, 0], Ks[..., 2, 1] = -rs[..., 1], rs[..., 0]
        R = np.where(small[..., None, None], I + Ks + 0.5 * (Ks @ Ks), R)
    return R


def _log(R):
    """[..., 3, 3] -> [..., 3] (f64), stable near 0 and pi."""
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    th = np.arccos(tr)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2],
                  R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    s = np.maximum(2 * np.sin(th), 1e-300)
    fac = np.where(th < 1e-7, 0.5 + th * th / 12, th / s)
    out = fac[..., None] * w
    # near pi the axis comes from the symmetric part
    near_pi = th > np.pi - 1e-3
    if np.any(near_pi):
        A = (R + np.swapaxes(R, -1, -2)) / 2
        d = np.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], -1)
        ax = np.sqrt(np.maximum((d + 1) / 2, 0))
        sign = np.sign(w)
        sign = np.where(sign == 0, 1.0, sign)
        out_pi = th[..., None] * ax * sign
        out = np.where(near_pi[..., None], out_pi, out)
    return out


def _retract(p6, d6):
    """(R Exp(dr), c + R dt) — the ba.factors.retract_single chart."""
    R = _exp(p6[..., :3])
    Rn = R @ _exp(d6[..., :3])
    c = p6[..., 3:] + (R @ d6[..., 3:, None])[..., 0]
    return Rn, c


# ---------- f64 residuals (ba/factors.py conventions) ----------

def _obs_res(d6, p6, pts, uv, cal9, inv_sig):
    R, c = _retract(p6, d6)
    Xc = (np.swapaxes(R, -1, -2) @ (pts - c)[..., None])[..., 0]
    z = np.where(np.abs(Xc[..., 2]) > 1e-9, Xc[..., 2], 1e-9)
    x = Xc[..., 0] / z
    y = Xc[..., 1] / z
    fx, fy, sk, u0, v0, k1, k2, t1, t2 = (cal9[..., i] for i in range(9))
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * k2)
    xd = x * rad + 2 * t1 * x * y + t2 * (r2 + 2 * x * x)
    yd = y * rad + t1 * (r2 + 2 * y * y) + 2 * t2 * x * y
    u = fx * xd + sk * yd + u0
    v = fy * yd + v0
    return (np.stack([u, v], -1) - uv) * inv_sig[..., None]


def _odo_res(df6, dt6, p6f, p6t, mr, mt, inv_sig6):
    Rf, cf = _retract(p6f, df6)
    Rt, ct = _retract(p6t, dt6)
    Rd = np.swapaxes(Rf, -1, -2) @ Rt
    td = (np.swapaxes(Rf, -1, -2) @ (ct - cf)[..., None])[..., 0]
    rr = _log(np.swapaxes(_exp(mr), -1, -2) @ Rd)
    return np.concatenate([rr, td - mt], axis=-1) * inv_sig6


def _pp_res(d6, p6, pr, pt, inv_sig6):
    R, c = _retract(p6, d6)
    rr = _log(np.swapaxes(_exp(pr), -1, -2) @ R)
    return np.concatenate([rr, c - pt], axis=-1) * inv_sig6


def _jac(fn, n_in, n_out, *args):
    """Central-difference Jacobian of fn wrt its first argument (the chart
    delta, shape [..., n_in]); returns [..., n_out, n_in]."""
    base_shape = args[0].shape[:-1]
    J = np.zeros(base_shape + (n_out, n_in))
    z = np.zeros(base_shape + (n_in,))
    for k in range(n_in):
        zp = z.copy()
        zp[..., k] = _H
        zm = z.copy()
        zm[..., k] = -_H
        J[..., :, k] = (fn(zp, *args) - fn(zm, *args)) / (2 * _H)
    return J


def _np(x, dtype=None):
    """Host copy of a tensor (or array) as an ndarray."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def polish64(problem, v, max_iters: int = 10, lam0: float = 1e-10,
             verbose: bool = False):
    """Polish BAVariables ``v`` for ``problem`` with f64 dense exact-Schur
    LM. Returns (BAVariables f32 on the problem's device, history of f64
    costs).  Span ``ba.polish64`` covers the whole: the reads to the host,
    the iterations and the result's copy back to the device."""
    with profiling.span("ba.polish64", problem.device):
        return _polish64(problem, v, max_iters, lam0, verbose)


def _polish64(problem, v, max_iters, lam0, verbose):
    F = int(problem.n_poses)
    P = int(problem.n_points)
    op = _np(problem.obs_pose)
    opt = _np(problem.obs_point)
    uv = _np(problem.obs_uv, np.float64)
    cal = _np(problem.calibrations, np.float64)[_np(problem.obs_cam)]
    inv_so = np.where(_np(problem.obs_valid),
                      1.0 / np.maximum(_np(problem.obs_sigma, np.float64),
                                       1e-12), 0.0)
    of = _np(problem.odo_from)
    ot = _np(problem.odo_to)
    mr = _np(problem.odo_r, np.float64)
    mt = _np(problem.odo_t, np.float64)
    inv_sq = np.where(_np(problem.odo_valid)[:, None],
                      1.0 / np.maximum(_np(problem.odo_sigma, np.float64),
                                       1e-12), 0.0)
    ppi = _np(problem.prior_pose_idx)
    ppr = _np(problem.prior_pose_r, np.float64)
    ppt = _np(problem.prior_pose_t, np.float64)
    inv_sp = np.where(_np(problem.prior_pose_valid)[:, None],
                      1.0 / np.maximum(_np(problem.prior_pose_sigma,
                                           np.float64), 1e-12), 0.0)
    qpi = _np(problem.prior_point_idx)
    qpx = _np(problem.prior_point_xyz, np.float64)
    inv_sqp = np.where(_np(problem.prior_point_valid),
                       1.0 / np.maximum(_np(problem.prior_point_sigma,
                                            np.float64), 1e-12), 0.0)
    pose_free = _np(problem.pose_valid)
    point_valid = _np(problem.point_valid)

    p6 = np.concatenate([_np(v.pose_r, np.float64),
                         _np(v.pose_t, np.float64)], axis=1)
    pts = _np(v.points, np.float64)

    def cost_of(p6c, ptsc):
        r_o = _obs_res(np.zeros_like(p6c[op]), p6c[op], ptsc[opt], uv, cal,
                       inv_so)
        r_q = _odo_res(np.zeros_like(p6c[of]), np.zeros_like(p6c[ot]),
                       p6c[of], p6c[ot], mr, mt, inv_sq)
        r_p = _pp_res(np.zeros_like(p6c[ppi]), p6c[ppi], ppr, ppt, inv_sp)
        r_qp = (ptsc[qpi] - qpx) * inv_sqp[:, None]
        return 0.5 * (np.sum(r_o ** 2) + np.sum(r_q ** 2)
                      + np.sum(r_p ** 2) + np.sum(r_qp ** 2))

    lam = lam0
    cost = cost_of(p6, pts)
    history = [cost]
    mask6 = np.repeat(pose_free, 6)
    for it in range(max_iters):
        # residuals + chart Jacobians
        r_o = _obs_res(np.zeros_like(p6[op]), p6[op], pts[opt], uv, cal,
                       inv_so)
        Jc = _jac(_obs_res, 6, 2, p6[op], pts[opt], uv, cal, inv_so)
        # point Jacobian: perturb the point additively
        Jp = np.zeros((len(op), 2, 3))
        for k in range(3):
            dp = np.zeros_like(pts[opt])
            dp[:, k] = _H
            Jp[:, :, k] = (_obs_res(np.zeros_like(p6[op]), p6[op],
                                    pts[opt] + dp, uv, cal, inv_so)
                           - _obs_res(np.zeros_like(p6[op]), p6[op],
                                      pts[opt] - dp, uv, cal, inv_so)
                           ) / (2 * _H)
        r_q = _odo_res(np.zeros_like(p6[of]), np.zeros_like(p6[ot]),
                       p6[of], p6[ot], mr, mt, inv_sq)
        Jqf = _jac(lambda d, *a: _odo_res(d, np.zeros_like(d), *a), 6, 6,
                   p6[of], p6[ot], mr, mt, inv_sq)
        Jqt = _jac(lambda d, *a: _odo_res(np.zeros_like(d), d, *a), 6, 6,
                   p6[of], p6[ot], mr, mt, inv_sq)
        r_p = _pp_res(np.zeros_like(p6[ppi]), p6[ppi], ppr, ppt, inv_sp)
        Jpp = _jac(_pp_res, 6, 6, p6[ppi], ppr, ppt, inv_sp)
        r_qp = (pts[qpi] - qpx) * inv_sqp[:, None]

        # dense assembly
        Hcc = np.zeros((F, 6, F, 6))
        np.add.at(Hcc, (op, slice(None), op, slice(None)),
                  np.einsum('okd,oke->ode', Jc, Jc))
        np.add.at(Hcc, (of, slice(None), of, slice(None)),
                  np.einsum('okd,oke->ode', Jqf, Jqf))
        np.add.at(Hcc, (of, slice(None), ot, slice(None)),
                  np.einsum('okd,oke->ode', Jqf, Jqt))
        np.add.at(Hcc, (ot, slice(None), of, slice(None)),
                  np.einsum('okd,oke->ode', Jqt, Jqf))
        np.add.at(Hcc, (ot, slice(None), ot, slice(None)),
                  np.einsum('okd,oke->ode', Jqt, Jqt))
        np.add.at(Hcc, (ppi, slice(None), ppi, slice(None)),
                  np.einsum('okd,oke->ode', Jpp, Jpp))
        Hpp = np.zeros((P, 3, 3))
        np.add.at(Hpp, opt, np.einsum('okd,oke->ode', Jp, Jp))
        np.add.at(Hpp, qpi, (inv_sqp ** 2)[:, None, None] * np.eye(3))
        W = np.zeros((F, 6, P, 3))
        np.add.at(W, (op, slice(None), opt, slice(None)),
                  np.einsum('okd,oke->ode', Jc, Jp))
        g_c = np.zeros((F, 6))
        np.add.at(g_c, op, np.einsum('okd,ok->od', Jc, r_o))
        np.add.at(g_c, of, np.einsum('okd,ok->od', Jqf, r_q))
        np.add.at(g_c, ot, np.einsum('okd,ok->od', Jqt, r_q))
        np.add.at(g_c, ppi, np.einsum('okd,ok->od', Jpp, r_p))
        g_p = np.zeros((P, 3))
        np.add.at(g_p, opt, np.einsum('okd,ok->od', Jp, r_o))
        np.add.at(g_p, qpi, r_qp * inv_sqp[:, None])

        point_free = point_valid & (np.einsum('pii->p', Hpp) > 0)
        dHpp = np.einsum('pii->pi', Hpp)
        Hpp_d = Hpp + (lam * np.maximum(dHpp, 1e-12))[..., None] * np.eye(3)
        Hppi = np.zeros_like(Hpp_d)
        Hppi[point_free] = np.linalg.inv(Hpp_d[point_free])

        dHcc = np.einsum('fdfd->fd', Hcc).copy()
        for f in range(F):
            Hcc[f, :, f, :] += np.diag(lam * np.maximum(dHcc[f], 1e-12))
        WH = np.einsum('fpe,pec->fpc', W.reshape(F * 6, P, 3),
                       Hppi).reshape(F * 6, P * 3)
        S = Hcc.reshape(F * 6, F * 6) - WH @ W.reshape(F * 6, P * 3).T
        b = -g_c.reshape(-1) + WH @ g_p.reshape(-1)
        dc = np.zeros(F * 6)
        try:
            dc[mask6] = np.linalg.solve(S[np.ix_(mask6, mask6)], b[mask6])
        except np.linalg.LinAlgError:
            break
        dcb = dc.reshape(F, 6)
        dpv = np.einsum('pec,pc->pe', -Hppi,
                        g_p + np.einsum('fdpe,fd->pe', W, dcb))
        dpv[~point_free] = 0

        Rn, cn = _retract(p6, dcb)
        p6_try = np.concatenate([_log(Rn), cn], axis=1)
        pts_try = pts + dpv
        nc = cost_of(p6_try, pts_try)
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

    dev = problem.init.pose_r.device
    out = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    return BAVariables(pose_r=out(p6[:, :3]), pose_t=out(p6[:, 3:]),
                       points=out(pts)), history
