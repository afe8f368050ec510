"""Plain bundle adjustment of an N-camera merged ``BA_info`` dump, in
float64 ``torch``, the landmarks eliminated by their 3x3 blocks.

``reference/ba.py``'s graph (``graph_from_data``: every camera's pose
chain, its landmarks and observations, odometry within a chain and across
chains, a prior on each chain's first pose and on the first step's
landmarks), factors, chart, damping, schedule and stop rule, unchanged and
imported from there.  What differs is how a step is solved: the dense
system over all 6F + 3P unknowns does not fit a fleet's map (F = 2,400
poses and tens of thousands of landmarks), so the damped normal equations

    [Hcc + lam Dc   W           ] [dc]   [-gc]
    [W^T            Hxx + lam Dx] [dx] = [-gx]

are reduced to the poses, S = Hcc + lam Dc - W (Hxx + lam Dx)^-1 W^T with
(Hxx + lam Dx) block-diagonal in 3x3 landmark blocks, S equilibrated by
its diagonal and factored by Cholesky, and the landmarks back-substituted,
dx = -(Hxx + lam Dx)^-1 (gx + W^T dc).  Hcc is dense [6F, 6F]; W M W^T is
built in blocks of ``CHUNK`` landmarks, each block a dense product over
the poses that observe them (landmarks ordered by their first observing
pose, so that a block's poses are few).  This is the same step as
``ba.py``'s dense solve, to roundoff, with Marquardt's damping lam times
the diagonal of each unknown.

Every Jacobian is ``torch.func.vmap(torch.func.jacfwd(...))`` of
``ba.py``'s residuals at zero increments.  ``control_answer`` runs the
same LM in a lower precision (bfloat16 for the benchmark's control), the
3x3 inverses and the Cholesky factorization in float32, which has them.
Imports nothing of the program, of the JAX package or of JAX.
"""

import torch
from torch.func import jacfwd, vmap

from benchmark.reference import ba as ref

__all__ = ["CHUNK", "Plan", "solve", "start_optimum", "gaps",
           "control_answer"]

CHUNK = 1024       # landmarks a block of W M W^T


def _jac(fn, inc, args, dtype):
    """(residuals [N, m], Jacobians [N, m, k] for each increment)."""
    argnums = tuple(range(len(inc)))
    J = vmap(jacfwd(fn, argnums=argnums))(*inc, *args)
    return vmap(fn)(*inc, *args), [j.to(dtype) for j in J]


def _rank(free):
    """Index among the free entries, -1 for a fixed one."""
    return torch.where(free, torch.cumsum(free.long(), 0) - 1, -1)


class Plan:
    """The reduced system's index tables for graph ``g`` (``ba.py``'s
    ``Graph`` with its free poses and landmarks), built once: each free
    pose's and landmark's rank, the observations that couple a free pose
    and a free landmark, and the blocks of landmarks with the poses each
    block's observations touch."""

    def __init__(self, g, chunk=CHUNK):
        self.g = g
        dev = g.pose_free.device
        self.kp = _rank(g.pose_free)                 # [F]
        self.kx = _rank(g.point_free)                # [P]
        self.fp = int(g.pose_free.sum())
        self.fx = int(g.point_free.sum())
        op, ox = self.kp[g.o_pose], self.kx[g.o_point]
        self.o_kp, self.o_kx = op, ox
        both = (op >= 0) & (ox >= 0)
        self.w_obs = torch.nonzero(both)[:, 0]       # observations in W
        self.pos = torch.zeros(len(op), dtype=torch.long, device=dev)
        self.pos[self.w_obs] = torch.arange(len(self.w_obs), device=dev)
        # free landmarks by their first observing free pose
        first = torch.full((self.fx,), self.fp, dtype=torch.long,
                           device=dev).scatter_reduce(
            0, ox[both], op[both], "amin")
        order = torch.argsort(first, stable=True)
        block = torch.empty_like(order)
        block[order] = torch.arange(self.fx, device=dev) // chunk
        self.blocks = []
        wb = block[ox[self.w_obs]]
        sort = torch.argsort(wb, stable=True)
        obs_sorted = self.w_obs[sort]
        counts = torch.bincount(wb, minlength=-(-self.fx // chunk)).tolist()
        at = 0
        for b, n in enumerate(counts):
            if n == 0:
                continue
            obs = obs_sorted[at:at + n]
            at += n
            poses, u = torch.unique(op[obs], return_inverse=True)
            pts = order[b * chunk:(b + 1) * chunk]
            j = torch.empty(self.fx, dtype=torch.long, device=dev)
            j[pts] = torch.arange(len(pts), device=dev)
            self.blocks.append((obs, poses, u, pts, j[ox[obs]]))

    def linearize(self, R, c, X):
        """The undamped system's parts at (R, c, X): Hcc [6fp, 6fp], gc
        [fp, 6], Hxx [fx, 3, 3], gx [fx, 3], the W blocks [O_w, 6, 3] of
        the observations in ``w_obs``."""
        g, dt, dev = self.g, R.dtype, R.device
        n = 6 * self.fp
        H = torch.zeros((n + 6) * (n + 6), dtype=dt, device=dev)
        gc = torch.zeros((self.fp + 1, 6), dtype=dt, device=dev)
        Hxx = torch.zeros((self.fx + 1, 3, 3), dtype=dt, device=dev)
        gx = torch.zeros((self.fx + 1, 3), dtype=dt, device=dev)
        ar6 = torch.arange(6, device=dev)
        z = lambda m, k: torch.zeros((m, k), dtype=dt, device=dev)
        slot = lambda k, fixed: torch.where(k >= 0, k, fixed)

        def add_cc(ka, kb, Ja, Jb):
            ia = 6 * slot(ka, self.fp)[:, None] + ar6
            ib = 6 * slot(kb, self.fp)[:, None] + ar6
            blk = torch.einsum("nmi,nmj->nij", Ja, Jb)
            H.index_add_(0, (ia[:, :, None] * (n + 6)
                             + ib[:, None, :]).reshape(-1), blk.reshape(-1))

        def add_gc(k, J, r):
            gc.index_add_(0, slot(k, self.fp),
                          torch.einsum("nmi,nm->ni", J, r))

        # projections
        n_o = len(g.o_pose)
        r, (Jc, Jx) = _jac(ref.obs_residual, (z(n_o, 6), z(n_o, 3)),
                           (R[g.o_pose], c[g.o_pose], X[g.o_point], g.o_uv,
                            g.o_cal, g.o_w), dt)
        add_cc(self.o_kp, self.o_kp, Jc, Jc)
        add_gc(self.o_kp, Jc, r)
        kx = slot(self.o_kx, self.fx)
        Hxx.index_add_(0, kx, torch.einsum("nmi,nmj->nij", Jx, Jx))
        gx.index_add_(0, kx, torch.einsum("nmi,nm->ni", Jx, r))
        w = self.w_obs
        A = torch.einsum("nmi,nmj->nij", Jc[w], Jx[w])
        # odometry, within and across chains
        n_q = len(g.q_from)
        if n_q:
            r, (Jf, Jt) = _jac(ref.odo_residual, (z(n_q, 6), z(n_q, 6)),
                               (R[g.q_from], c[g.q_from], R[g.q_to],
                                c[g.q_to], g.q_R, g.q_t, g.q_w), dt)
            kf, kt = self.kp[g.q_from], self.kp[g.q_to]
            for ka, Ja in ((kf, Jf), (kt, Jt)):
                for kb, Jb in ((kf, Jf), (kt, Jt)):
                    add_cc(ka, kb, Ja, Jb)
                add_gc(ka, Ja, r)
        # pose priors
        n_p = len(g.pp_idx)
        if n_p:
            r, (Jp,) = _jac(ref.pose_prior_residual, (z(n_p, 6),),
                            (R[g.pp_idx], c[g.pp_idx], g.pp_R, g.pp_c,
                             g.pp_w), dt)
            kp = self.kp[g.pp_idx]
            add_cc(kp, kp, Jp, Jp)
            add_gc(kp, Jp, r)
        # landmark priors
        n_x = len(g.qp_idx)
        if n_x:
            r, (Jq,) = _jac(ref.point_prior_residual, (z(n_x, 3),),
                            (X[g.qp_idx], g.qp_X,
                             torch.full((n_x,), g.qp_w, dtype=dt,
                                        device=dev)), dt)
            kq = slot(self.kx[g.qp_idx], self.fx)
            Hxx.index_add_(0, kq, torch.einsum("nmi,nmj->nij", Jq, Jq))
            gx.index_add_(0, kq, torch.einsum("nmi,nm->ni", Jq, r))
        H = H.reshape(n + 6, n + 6)[:n, :n]
        return H, gc[:self.fp], Hxx[:self.fx], gx[:self.fx], A

    def step(self, system, lam):
        """The damped step (flat [6fp + 3fx], ``ba.py``'s order of the
        unknowns), or None where the reduced system's Cholesky fails."""
        H, gc, Hxx, gx, A = system
        dt = H.dtype
        fact = torch.promote_types(dt, torch.float32)
        eye3 = torch.eye(3, dtype=dt, device=H.device)
        dx_diag = torch.diagonal(Hxx, dim1=-2, dim2=-1)
        M = torch.linalg.inv((Hxx + lam * torch.clamp(dx_diag, min=1e-30)
                              [..., None] * eye3).to(fact)).to(dt)
        S = H + torch.diag(lam * torch.clamp(torch.diagonal(H), min=1e-30))
        t = torch.einsum("pij,pj->pi", M, gx)                    # M gx
        kp, kx = self.o_kp[self.w_obs], self.o_kx[self.w_obs]
        b = -gc.reshape(-1) + torch.zeros_like(gc).index_add_(
            0, kp, torch.einsum("nij,nj->ni", A, t[kx])).reshape(-1)
        ar6 = torch.arange(6, device=H.device)
        for obs, poses, u, pts, j in self.blocks:
            nu, nj = len(poses), len(pts)
            Wb = torch.zeros((nu, nj, 6, 3), dtype=dt, device=H.device)
            Wb.index_put_((u, j), A[self.pos[obs]], accumulate=True)
            WM = torch.einsum("ujab,jbc->ujac", Wb, M[pts])
            corr = torch.einsum("ujac,vjbc->uavb", WM, Wb).reshape(
                6 * nu, 6 * nu)
            ii = (6 * poses[:, None] + ar6).reshape(-1)
            S.index_put_((ii[:, None], ii[None, :]), -corr, accumulate=True)
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-30))
        L, info = torch.linalg.cholesky_ex((S / (d[:, None] * d[None, :]))
                                           .to(fact))
        if int(info) != 0:
            return None
        dc = (torch.cholesky_solve((b / d)[:, None].to(fact), L)[:, 0]
              .to(dt) / d)
        back = gx + torch.zeros_like(gx).index_add_(
            0, kx, torch.einsum("nij,ni->nj", A, dc.reshape(-1, 6)[kp]))
        dx = -torch.einsum("pij,pj->pi", M, back)
        return torch.cat([dc, dx.reshape(-1)])


def solve(g, R, c, X, max_iters=200, lam0=1e-4, lam_min=1e-12,
          lam_max=1e12):
    """``ba.solve``'s LM, each step by the reduced system (``Plan``);
    returns (R, c, X, history of accepted costs as floats, outer
    iterations)."""
    ref._no_tf32()
    plan = Plan(g)
    lam = lam0
    f = float(ref.cost(g, R, c, X))
    hist = [f]
    it = 0
    for it in range(1, max_iters + 1):
        system = plan.linearize(R, c, X)
        while True:
            step = plan.step(system, lam)
            if step is not None:
                step_norm = float(torch.linalg.vector_norm(step))
                Rn, cn, Xn = ref._apply(g, R, c, X, step)
                fn = float(ref.cost(g, Rn, cn, Xn))
                if fn < f:
                    break
                if step_norm < ref.STEP_NORM:
                    return R, c, X, hist, it
            lam *= 10.0
            if lam > lam_max:
                return R, c, X, hist, it
        R, c, X = Rn, cn, Xn
        decrease = f - fn
        f = fn
        hist.append(f)
        lam = max(lam / 10.0, lam_min)
        if decrease < ref.REL_DECREASE * f or step_norm < ref.STEP_NORM:
            break
    return R, c, X, hist, it


def start_optimum(g, data, device):
    """The cost this LM reaches from ``data``'s own estimates over graph
    ``g`` (``ba.graph_from_data(data)``), every landmark free."""
    return solve(g, *ref.variables_from_data(data, device))[3][-1]


def gaps(g, answer, optimum, min_obs=3, max_rel_sigma=0.1):
    """``ba.gaps``' numbers of an answer (R [F, 3, 3], c [F, 3], X [P, 3],
    float64 on the graph's device) against graph ``g`` whose
    ``start_optimum`` is ``optimum``: ``cost_excess_rel`` over the whole
    graph, then this LM from the answer over the poses and the landmarks
    the answer determines, and ``cost_gap_rel``, ``center_gap_m``,
    ``rot_gap_rad`` and ``point_gap_rel`` from its optimum."""
    R, c, X = answer
    det = ref.determined_points(g, R, c, X, min_obs, max_rel_sigma)
    R1, c1, X1, hist, _ = solve(g.free_points(det), R, c, X)
    depth = ref.point_depths(g, R1, c1, X1)
    free = g.pose_free
    point = (torch.linalg.vector_norm(X - X1, dim=-1) / depth)[det]
    return dict(
        cost_excess_rel=(hist[0] - optimum) / optimum,
        cost_gap_rel=(hist[0] - hist[-1]) / hist[-1],
        center_gap_m=float(torch.linalg.vector_norm(c - c1, dim=-1)[free]
                           .max()),
        rot_gap_rad=float(ref.rotation_gaps(R, R1)[free].max()),
        point_gap_rel=float(point.max()) if len(point) else 0.0)


def control_answer(g, data, device, dtype=torch.bfloat16):
    """The control's answer: this LM in ``dtype`` over graph ``g`` from
    the dump's estimates (R, c, X in ``dtype``)."""
    R, c, X = ref.variables_from_data(data, device, dtype)
    return solve(g.to(dtype), R, c, X)[:3]
