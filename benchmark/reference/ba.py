"""Plain bundle adjustment of a ``BA_info`` dump, in float64 ``torch``.

Written from the wire format (``BAData``: per-camera pose chains, a
landmark store, 2D-3D associations, odometry between poses, noise models,
Cal3DS2 calibrations) and the factor conventions the program documents
(``ba/factors.py``), not from the program's code:

- poses are camera-to-world (R, c); a pose moves in the body-frame chart
  R' = R Exp(dr), c' = c + R dt; a landmark moves additively;
- projection: X_c = R^T (X - c), x = X_c / z, Cal3DS2 distortion
  (k1, k2 radial, p1, p2 tangential), then K; residual (projection - uv)
  over the pixel sigma;
- odometry, measured M = W_from^-1 W_to: residual [Log(R_M^T R_f^T R_t),
  R_f^T (c_t - c_f) - t_M] over its six sigmas (rotation xyz first);
- pose prior on each camera's first pose, at its initial value: residual
  [Log(R_p^T R), c - c_p] over its six sigmas;
- point prior on the first step's landmarks, at their initial values:
  (X - X_p) over the landmark sigma;
- cost 0.5 * the sum of squared residuals.

The graph takes the factors the program's ``problem_from_ba_data`` takes:
holes in a trajectory are not optimized and their factors dropped, a
landmark is optimized from the step that adds it, associations to later
frames or landmarks are dropped.

Every factor's Jacobian is ``torch.func.vmap(torch.func.jacfwd(...))`` of
its residual at zero increments.  The normal equations are dense over all
6F + 3P unknowns of the free poses and landmarks (no Schur complement, no
layout, no batching), equilibrated by their diagonal and solved by
Cholesky; LM runs until a step lowers the cost by less than 1e-12 of it,
or a step's norm is below 1e-10, or no damping finds a lower cost.

Departures from the program's definitions:

- rotations are held as matrices, not rotation vectors, and every value
  is float64 from the wire format (the program rounds its inputs to
  float32 and starts from float32 rotation vectors);
- the perspective division has no guard at z = 0 (the program clamps
  |z| to 1e-9): no landmark of a sound map lies in a camera's plane;
- the SO(3) logarithm has no branch near pi: residual rotations are small;
- damping is Marquardt's on the equilibrated system (lambda times the
  identity after scaling by the diagonal); the program damps its reduced
  system the same way but in another schedule.

``control_answer`` runs the same LM from the dump's estimates in a lower
precision (bfloat16 for the benchmark's control), with no float64 finish.
Imports nothing of the program, of the JAX package or of JAX.
"""

import numpy as np
import torch
from torch.func import jacfwd, vmap

__all__ = ["Graph", "graph_from_data", "variables_from_data", "cost",
           "solve", "start_optimum", "gaps", "control_answer", "rotation_gaps",
           "determined_points", "point_depths",
           "exp_so3", "log_so3", "obs_residual", "odo_residual",
           "pose_prior_residual", "point_prior_residual", "REL_DECREASE",
           "STEP_NORM"]

REL_DECREASE = 1e-12
STEP_NORM = 1e-10
_SMALL = 1e-6       # below this squared angle the series forms hold


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_so3(w):
    """Rotation matrices [..., 3, 3] of rotation vectors [..., 3]
    (Rodrigues, by its series below a squared angle of 1e-6, so that its
    derivative at zero is exact)."""
    t2 = torch.sum(w * w, -1)
    small = t2 < _SMALL
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720,
                    (1 - torch.cos(t)) / (t * t))
    K = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R):
    """Rotation vectors [..., 3] of rotation matrices [..., 3, 3], angles
    below pi / 2 by the arcsine's series near zero."""
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = torch.sum(w * w, -1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    small = s2 < _SMALL
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    f = torch.where(small, 1 + s2 / 6 + 3 * s2 * s2 / 40,
                    torch.atan2(s, c) / s)
    return f[..., None] * w


def _retract(R, c, d6):
    return R @ exp_so3(d6[:3]), c + R @ d6[3:]


def obs_residual(d6, d3, R, c, X, uv, cal, w):
    """Whitened pixel residual [2] of one observation at increments
    (d6 of its pose, d3 of its landmark)."""
    Rn, cn = _retract(R, c, d6)
    Xc = Rn.T @ (X + d3 - cn)
    x, y = Xc[0] / Xc[2], Xc[1] / Xc[2]
    fx, fy, sk, u0, v0, k1, k2, p1, p2 = cal
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * k2)
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return (torch.stack([fx * xd + sk * yd + u0, fy * yd + v0]) - uv) * w


def odo_residual(df, dt, Rf, cf, Rt, ct, Rm, tm, w6):
    """Whitened between residual [6] at increments of its two poses."""
    Rf, cf = _retract(Rf, cf, df)
    Rt, ct = _retract(Rt, ct, dt)
    rot = log_so3(Rm.T @ Rf.T @ Rt)
    return torch.cat([rot, Rf.T @ (ct - cf) - tm]) * w6


def pose_prior_residual(d6, R, c, Rp, cp, w6):
    Rn, cn = _retract(R, c, d6)
    return torch.cat([log_so3(Rp.T @ Rn), cn - cp]) * w6


def point_prior_residual(d3, X, Xp, w):
    return (X + d3 - Xp) * w


class Graph:
    """The factors of one dump as tensors on one device, with the index of
    each free unknown in the dense system.  Pose k is camera k // S, frame
    k % S; ``pose_free`` / ``point_free`` mark what is optimized."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def free_points(self, point_free):
        """The same graph optimizing the landmarks ``point_free`` [P]
        (bool), each free pose and landmark given its columns of the dense
        system (-1: held fixed)."""
        dev = point_free.device
        cols = lambda free, k, at: torch.where(
            free, at + k * (torch.cumsum(free.long(), 0) - 1), -1)
        n_pose = 6 * int(self.pose_free.sum())
        return Graph(**dict(
            self.__dict__, point_free=point_free,
            pose_col=cols(self.pose_free, 6, 0).to(dev),
            point_col=cols(point_free, 3, n_pose).to(dev),
            n=n_pose + 3 * int(point_free.sum())))

    def to(self, dtype):
        conv = {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                    else v) for k, v in self.__dict__.items()}
        return Graph(**conv)


def _sigmas(model, n):
    return np.broadcast_to(np.asarray(model.sigmas, np.float64), (n,))


def graph_from_data(data, device, use_odometry=True, dtype=torch.float64):
    """The factor graph of a ``BAData`` (any object with its fields) on
    ``device``."""
    _no_tf32()
    C, S = data.nr_cameras, len(data.point3D_added_idxs)
    P = len(data.points3D)
    pose_ok = np.array([data.poses[c][f] is not None for c in range(C)
                        for f in range(S)], bool)
    point_ok = np.zeros(P, bool)
    for s in range(S):
        for i in data.point3D_added_idxs[s]:
            if i < P:
                point_ok[i] = True

    o_pose, o_point, o_uv, o_w = [], [], [], []
    for c in range(C):
        w = 1.0 / float(data.point2D_noise[c].sigmas[0])
        for s in range(min(S, len(data.point2D3D_assocs[c]))):
            for f, p2, p3 in np.asarray(data.point2D3D_assocs[c][s],
                                        np.int64).reshape(-1, 3):
                if f >= S or not pose_ok[c * S + f] or p3 >= P \
                        or not point_ok[p3]:
                    continue
                o_pose.append(c * S + f)
                o_point.append(p3)
                o_uv.append(data.points2D[c][f][p2])
                o_w.append(w)
    q_from, q_to, q_M, q_w = [], [], [], []
    if use_odometry:
        for s in range(min(S, len(data.odometry_assocs))):
            for k, (fc, ff, tc, tf) in enumerate(data.odometry_assocs[s]):
                if ff >= S or tf >= S or not (pose_ok[fc * S + ff]
                                              and pose_ok[tc * S + tf]):
                    continue
                nm = data.odometry_noise[fc][tc]
                q_from.append(fc * S + ff)
                q_to.append(tc * S + tf)
                q_M.append(np.asarray(data.odometry[s][k], np.float64))
                q_w.append(1.0 / (_sigmas(nm, 6) if nm is not None
                                  else np.ones(6)))
    pp_idx, pp_w = [], []
    for c in range(C):
        first = np.flatnonzero(pose_ok[c * S:(c + 1) * S])
        if len(first):
            pp_idx.append(c * S + int(first[0]))
            pp_w.append(1.0 / _sigmas(data.pose_noise[c], 6))
    qp_idx = [i for i in (data.point3D_added_idxs[0] if S else []) if i < P]
    qp_w = 1.0 / float(data.point3D_noise.sigmas[0]) if qp_idx else 1.0

    R0, c0, X0 = variables_from_data(data, device, dtype)
    observed = np.zeros(P, bool)
    observed[o_point] = True
    observed[qp_idx] = True

    T = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=device)
    L = lambda a: T(np.asarray(a, np.int64), torch.int64)
    M = np.asarray(q_M, np.float64).reshape(-1, 4, 4)
    return Graph(
        C=C, S=S, P=P, pose_free=T(pose_ok, torch.bool),
        o_pose=L(o_pose), o_point=L(o_point),
        o_uv=T(np.asarray(o_uv, np.float64).reshape(-1, 2)),
        o_w=T(o_w), o_cal=T(np.stack([np.asarray(data.calibrations[p // S],
                                                 np.float64)
                                      for p in o_pose]).reshape(-1, 9)),
        q_from=L(q_from), q_to=L(q_to), q_R=T(M[:, :3, :3]),
        q_t=T(M[:, :3, 3]), q_w=T(np.asarray(q_w).reshape(-1, 6)),
        pp_idx=L(pp_idx), pp_R=R0[L(pp_idx)], pp_c=c0[L(pp_idx)],
        pp_w=T(np.asarray(pp_w).reshape(-1, 6)),
        qp_idx=L(qp_idx), qp_X=X0[L(qp_idx)],
        qp_w=qp_w).free_points(T(point_ok & observed, torch.bool))


def variables_from_data(data, device, dtype=torch.float64):
    """(R [C*S, 3, 3], c [C*S, 3], X [P, 3]) of a dump's estimates; holes
    hold the identity at the origin."""
    C, S = data.nr_cameras, len(data.point3D_added_idxs)
    W = np.tile(np.eye(4), (C * S, 1, 1))
    for c in range(C):
        for f in range(S):
            if data.poses[c][f] is not None:
                W[c * S + f] = data.poses[c][f][0]
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return (T(W[:, :3, :3]), T(W[:, :3, 3]),
            T(np.asarray(data.points3D, np.float64).reshape(-1, 3)))


def _factors(g, R, c, X):
    """[(residual function, the increments it takes, its other arguments
    batched, the dense system's columns [N, k] of its increments (-1: a
    fixed unknown))] of each factor kind that has factors."""
    dt, dev = R.dtype, R.device
    ar6 = torch.arange(6, device=dev)
    pcol = lambda i: torch.where(g.pose_col[i][:, None] >= 0,
                                 g.pose_col[i][:, None] + ar6, -1)
    xcol = lambda i: torch.where(g.point_col[i][:, None] >= 0,
                                 g.point_col[i][:, None] + ar6[:3], -1)
    z = lambda n, k: torch.zeros((n, k), dtype=dt, device=dev)
    n_o, n_q = len(g.o_pose), len(g.q_from)
    n_p, n_x = len(g.pp_idx), len(g.qp_idx)
    kinds = [
        (obs_residual, (z(n_o, 6), z(n_o, 3)),
         (R[g.o_pose], c[g.o_pose], X[g.o_point], g.o_uv, g.o_cal, g.o_w),
         lambda: torch.cat([pcol(g.o_pose), xcol(g.o_point)], -1)),
        (odo_residual, (z(n_q, 6), z(n_q, 6)),
         (R[g.q_from], c[g.q_from], R[g.q_to], c[g.q_to], g.q_R, g.q_t,
          g.q_w),
         lambda: torch.cat([pcol(g.q_from), pcol(g.q_to)], -1)),
        (pose_prior_residual, (z(n_p, 6),),
         (R[g.pp_idx], c[g.pp_idx], g.pp_R, g.pp_c, g.pp_w),
         lambda: pcol(g.pp_idx)),
        (point_prior_residual, (z(n_x, 3),),
         (X[g.qp_idx], g.qp_X,
          torch.full((n_x,), g.qp_w, dtype=dt, device=dev)),
         lambda: xcol(g.qp_idx))]
    return [k for k in kinds if len(k[1][0])]


def cost(g, R, c, X):
    """0.5 * the sum of squared whitened residuals (a 0-dim tensor)."""
    return 0.5 * sum(torch.sum(vmap(fn)(*inc, *args) ** 2)
                     for fn, inc, args, _ in _factors(g, R, c, X))


def _blocks(g, R, c, X):
    """[(residuals [N, m], Jacobian [N, m, k], columns [N, k])] of each
    factor kind over the dense system's unknowns."""
    out = []
    for fn, inc, args, cols in _factors(g, R, c, X):
        J = vmap(jacfwd(fn, argnums=tuple(range(len(inc)))))(*inc, *args)
        # jacfwd carries some tangents in float64 whatever the inputs:
        # the Jacobian in the inputs' precision
        out.append((vmap(fn)(*inc, *args), torch.cat(J, -1).to(R.dtype),
                    cols()))
    return out


def normal_equations(g, R, c, X):
    """(H [n, n], gradient [n]) of the dense Gauss-Newton system."""
    H = torch.zeros((g.n + 1) * (g.n + 1), dtype=R.dtype, device=R.device)
    b = torch.zeros(g.n + 1, dtype=R.dtype, device=R.device)
    for r, J, col in _blocks(g, R, c, X):
        col = torch.where(col >= 0, col, g.n)     # fixed: a spare row
        JtJ = torch.einsum("nmi,nmj->nij", J, J)
        H.index_add_(0, (col[:, :, None] * (g.n + 1)
                         + col[:, None, :]).reshape(-1), JtJ.reshape(-1))
        b.index_add_(0, col.reshape(-1),
                     torch.einsum("nmi,nm->ni", J, r).reshape(-1))
    H = H.reshape(g.n + 1, g.n + 1)
    return H[:g.n, :g.n], b[:g.n]


def _apply(g, R, c, X, delta):
    pose_rows = torch.nonzero(g.pose_free)[:, 0]
    point_rows = torch.nonzero(g.point_free)[:, 0]
    dp = delta[:6 * len(pose_rows)].reshape(-1, 6)
    dx = delta[6 * len(pose_rows):].reshape(-1, 3)
    Rn, cn, Xn = R.clone(), c.clone(), X.clone()
    Rp = R[pose_rows]
    Rn[pose_rows] = Rp @ exp_so3(dp[:, :3])
    cn[pose_rows] = c[pose_rows] + (Rp @ dp[:, 3:, None])[..., 0]
    Xn[point_rows] = X[point_rows] + dx
    return Rn, cn, Xn


def solve(g, R, c, X, max_iters=200, lam0=1e-4, lam_min=1e-12,
          lam_max=1e12):
    """LM from (R, c, X) to convergence; returns (R, c, X, history of
    accepted costs as floats, outer iterations).  Damping lam times the
    identity of the equilibrated system, divided by 10 after an accepted
    step (not below ``lam_min``: a landmark seen along one ray has a null
    direction, which an undamped solve fills with roundoff) and
    multiplied by 10 after a rejected one."""
    _no_tf32()
    lam = lam0
    f = float(cost(g, R, c, X))
    hist = [f]
    it = 0
    for it in range(1, max_iters + 1):
        H, grad = normal_equations(g, R, c, X)
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
        A = H / (d[:, None] * d[None, :])
        rhs = -grad / d
        eye = torch.eye(g.n, dtype=H.dtype, device=H.device)
        fact = torch.promote_types(A.dtype, torch.float32)
        while True:
            L, info = torch.linalg.cholesky_ex((A + lam * eye).to(fact))
            if int(info) == 0:
                step = (torch.cholesky_solve(rhs[:, None].to(fact), L)[:, 0]
                        .to(A.dtype) / d)
                step_norm = float(torch.linalg.vector_norm(step))
                Rn, cn, Xn = _apply(g, R, c, X, step)
                fn = float(cost(g, Rn, cn, Xn))
                if fn < f:
                    break
                if step_norm < STEP_NORM:
                    return R, c, X, hist, it
            lam *= 10.0
            if lam > lam_max:
                return R, c, X, hist, it
        R, c, X = Rn, cn, Xn
        decrease = f - fn
        f = fn
        hist.append(f)
        lam = max(lam / 10.0, lam_min)
        if decrease < REL_DECREASE * f or step_norm < STEP_NORM:
            break
    return R, c, X, hist, it


def start_optimum(data, device, use_odometry=True):
    """The cost the float64 LM reaches from ``data``'s own estimates over
    the whole graph, every landmark free."""
    g = graph_from_data(data, device, use_odometry)
    return solve(g, *variables_from_data(data, device))[3][-1]


def gaps(data, answer, device, optimum, min_obs=3, max_rel_sigma=0.1,
         use_odometry=True):
    """The compared numbers of an answer (R [F, 3, 3], c [F, 3], X [P, 3],
    indexed as the dump's poses camera * S + frame and its landmarks) to
    ``data``, whose ``start_optimum`` is ``optimum``:

    - ``cost_excess_rel``: the answer's cost over the whole graph less
      ``optimum``, over ``optimum`` (negative where the answer lies
      lower): a global check, which sees an answer in a worse basin and
      landmarks pushed out of the determined set;

    then float64 LM run from the answer to convergence, and

    - ``cost_gap_rel``: the answer's cost less the optimum's, over it;
    - ``center_gap_m``: the largest distance of a free pose's centre from
      the optimum's;
    - ``rot_gap_rad``: the largest angle between a free pose's rotation
      and the optimum's;
    - ``point_gap_rel``: the largest distance of a landmark from the
      optimum's over its depth, over the landmarks the answer determines
      (``determined_points(min_obs, max_rel_sigma)``).

    The solve starts from the answer, not from the dump, and moves the
    poses and the landmarks the answer determines, holding the others where
    the answer put them: the map has landmarks that recede without bound
    and more than one local optimum, and a solve over those settles in
    another basin from one start to the next (a float64 solve from the
    dump's start ends 31 above the float32 program's optimum, and one from
    a program's answer sometimes 46 below it, the centres 7 mm away)."""
    g = graph_from_data(data, device, use_odometry)
    R, c, X = (torch.as_tensor(a, dtype=torch.float64).to(device)
               for a in answer)
    det = determined_points(g, R, c, X, min_obs, max_rel_sigma)
    R1, c1, X1, hist, _ = solve(g.free_points(det), R, c, X)
    depth = point_depths(g, R1, c1, X1)
    free = g.pose_free
    point = (torch.linalg.vector_norm(X - X1, dim=-1) / depth)[det]
    return dict(
        cost_excess_rel=(hist[0] - optimum) / optimum,
        cost_gap_rel=(hist[0] - hist[-1]) / hist[-1],
        center_gap_m=float(torch.linalg.vector_norm(c - c1, dim=-1)[free]
                           .max()),
        rot_gap_rad=float(rotation_gaps(R, R1)[free].max()),
        point_gap_rel=float(point.max()) if len(point) else 0.0)


def control_answer(data, device, use_odometry=True, dtype=torch.float32):
    """The control's answer: this LM in ``dtype`` from the dump's
    estimates, with no float64 finish (R, c, X in ``dtype``; a bfloat16
    system is factored in float32, which has the factorization)."""
    g = graph_from_data(data, device, use_odometry).to(dtype)
    R, c, X = variables_from_data(data, device, dtype)
    return solve(g, R, c, X)[:3]


def rotation_gaps(Ra, Rb):
    """Angle (rad) between rotation matrices, [...]; accurate at small
    angles (arctangent of the sine and cosine parts)."""
    E = Ra.transpose(-1, -2) @ Rb
    w = 0.5 * torch.stack([E[..., 2, 1] - E[..., 1, 2],
                           E[..., 0, 2] - E[..., 2, 0],
                           E[..., 1, 0] - E[..., 0, 1]], -1)
    cos = 0.5 * (E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2] - 1)
    return torch.atan2(torch.linalg.vector_norm(w, dim=-1), cos)


def point_depths(g, R, c, X):
    """Each landmark's least depth (its z in the frames that observe it);
    inf where none does."""
    Xc = (R[g.o_pose].transpose(-1, -2)
          @ (X[g.o_point] - c[g.o_pose])[..., None])[..., 0]
    depth = torch.full((g.P,), float("inf"), dtype=X.dtype, device=X.device)
    return depth.scatter_reduce(0, g.o_point, Xc[:, 2], "amin")


def determined_points(g, R, c, X, min_obs=3, max_rel_sigma=0.1):
    """Landmarks (R, c, X) determines: free, seen at least ``min_obs``
    times, and whose position given the poses is known to ``max_rel_sigma``
    of its depth along its weakest direction (the landmark's 3x3 block of
    the normal equations: 1 / sqrt of its least eigenvalue)."""
    dt, dev = R.dtype, R.device
    n_o = len(g.o_pose)
    z = lambda k: torch.zeros((n_o, k), dtype=dt, device=dev)
    J = vmap(jacfwd(obs_residual, argnums=1))(
        z(6), z(3), R[g.o_pose], c[g.o_pose], X[g.o_point], g.o_uv,
        g.o_cal, g.o_w)
    Hx = torch.zeros((g.P, 3, 3), dtype=dt, device=dev).index_add_(
        0, g.o_point, torch.einsum("nmi,nmj->nij", J, J).to(dt))
    n_seen = torch.bincount(g.o_point, minlength=g.P)
    least = torch.linalg.eigvalsh(Hx + 1e-30 * torch.eye(3, dtype=dt,
                                                         device=dev))[:, 0]
    sigma = 1.0 / torch.sqrt(torch.clamp(least, min=1e-300))
    depth = point_depths(g, R, c, X)
    return g.point_free & (n_seen >= min_obs) & (depth > 0) & (
        sigma <= max_rel_sigma * depth)
