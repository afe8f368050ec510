"""Damped Gauss-Newton (LM) over a Schur-complement reduced camera system,
dense path.

At each outer iteration the problem is linearized once and the landmarks
are marginalized: ``solve_delta_dense`` materializes the reduced system

    S = Hcc + lam D - W (Hpp + lam Dp)^-1 W^T

with one scatter of the per-observation W blocks and one matrix product,
equilibrates it, Cholesky-factors it and solves exactly, with two passes of
iterative refinement; landmark increments come from closed-form damped 3x3
back-substitution.  Every operation is a PyTorch library call: the
JAX package's ``segment_sum`` is ``index_add_``, its ``.at[].add`` scatter
``index_add_`` on a zeros tensor, its HIGHEST-precision ``einsum`` an
``einsum`` with TF32 off, its ``cholesky`` / ``solve_triangular``
``torch.linalg.cholesky_ex`` / ``solve_triangular``.

A failed factorization is a rejected LM step, as in the JAX package: XLA's
Cholesky returns NaN for a matrix that is not positive definite, so the
step's cost is NaN and ``new_cost < cost`` is false.  ``cholesky_ex``
reports the failure in ``info`` on the device; the factor is turned into
NaN there, with no host read.

The matrix-free PCG path (``method="cg"``), its packed and banded layouts
and the sharded solves (``axis_name``) are not ported yet (ROADMAP Queue 1
item 11); asking for them raises.  ``"auto"`` picks dense on every problem
within the dense path's size gates.
"""

import contextlib
from typing import NamedTuple

import torch

from mqslam_tpu_torch.ba import factors
from mqslam_tpu_torch.ba.problem import BAProblem, BAVariables
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.core.smallmat import matmul_small, matvec_small
from mqslam_tpu_torch.ops import linalg

__all__ = ["dense_method_ok", "Linearization", "linearize",
           "solve_delta_dense", "apply_delta", "compute_cost", "lm_solve",
           "lm_solve_device", "ba_solve"]

# Auto-method gates of the dense-Schur path.  Besides the [6F, 6F] reduced
# system, solve_delta_dense materializes two [F*P, 6, 3] float32 transients
# (W and WH), O(F*P) memory whatever F, so "auto" also bounds F*P; the same
# bound keeps the flat int32 scatter index obs_pose * P + obs_point well
# inside 2^31.
_DENSE_MAX_POSE_DIM = 4096
_DENSE_MAX_FP = 8 * 1024 * 1024

_NOT_PORTED = ("waits for ROADMAP Queue 1 item 11 (BA at scale: the "
               "matrix-free PCG path, its layouts and sharded solves)")


def dense_method_ok(problem: BAProblem) -> bool:
    """True when solve_delta_dense is safe and sensible for this size."""
    return (problem.n_poses * 6 <= _DENSE_MAX_POSE_DIM
            and problem.n_poses * problem.n_points <= _DENSE_MAX_FP)


def _check_method(problem, method, layout):
    """Only the dense path is ported: ``"auto"`` must resolve to it."""
    if method not in ("auto", "dense"):
        raise ValueError(f"method={method!r} {_NOT_PORTED}")
    if method == "auto" and not dense_method_ok(problem):
        raise ValueError(
            f"BA problem with F = {problem.n_poses} poses and P = "
            f"{problem.n_points} points is past the dense path's gates; "
            f"the CG path it needs {_NOT_PORTED}")
    if layout not in ("auto", None):
        raise ValueError(f"layout={layout!r} {_NOT_PORTED}")


@contextlib.contextmanager
def _exact_f32():
    """Matrix products in full float32 (TF32 off), as the JAX package's
    ``precision=HIGHEST``; the global setting is restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _seg(vals, idx, n):
    """segment_sum: rows of ``vals`` added into ``n`` rows at ``idx``."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


# Tiny block contractions as broadcast + sum (exact float32).
def _Jv(J, v):
    """[N, k, d] x [N, d] -> [N, k]"""
    return torch.sum(J * v[:, None, :], dim=-1)


def _JTr(J, r):
    """[N, k, d] x [N, k] -> [N, d]"""
    return torch.sum(J * r[:, :, None], dim=-2)


def _JTJ(J):
    """[N, k, d] -> [N, d, d]"""
    return torch.sum(J[:, :, :, None] * J[:, :, None, :], dim=1)


def _JTJ_diag(J):
    """[N, k, d] -> [N, d]"""
    return torch.sum(J * J, dim=1)


class Linearization(NamedTuple):
    r_obs: torch.Tensor       # [O, 2] whitened
    J_obs_pose: torch.Tensor  # [O, 2, 6]
    J_obs_point: torch.Tensor  # [O, 2, 3]
    r_odo: torch.Tensor       # [Q, 6]
    J_odo_from: torch.Tensor  # [Q, 6, 6]
    J_odo_to: torch.Tensor    # [Q, 6, 6]
    r_pp: torch.Tensor        # [Rp, 6]
    J_pp: torch.Tensor        # [Rp, 6, 6]
    r_qp: torch.Tensor        # [Rq, 3] point-prior residual
    cost: torch.Tensor
    g_pose: torch.Tensor      # [F, 6] gradient wrt poses
    g_point: torch.Tensor     # [P, 3] gradient wrt points
    Hpp: torch.Tensor         # [P, 3, 3] point blocks (undamped)
    diag_pose: torch.Tensor   # [F, 6] diag of Hcc
    pose_free: torch.Tensor   # [F] bool — optimized pose entries
    point_free: torch.Tensor  # [P] bool


def _pose6(v: BAVariables):
    return torch.cat([v.pose_r, v.pose_t], dim=-1)          # [F, 6]


def _inv_sigma(valid, sigma):
    return torch.where(valid, 1.0 / torch.clamp(sigma, min=1e-12), 0.0)


def _gather_obs(problem: BAProblem, v: BAVariables):
    p6 = _pose6(v)[problem.obs_pose]
    pts = v.points[problem.obs_point]
    cal = problem.calibrations[problem.obs_cam]
    inv_sig = _inv_sigma(problem.obs_valid, problem.obs_sigma)
    return p6, pts, cal, inv_sig[:, None]


def _weights(problem: BAProblem):
    """Whitening of the odometry, pose-prior and point-prior rows."""
    return (_inv_sigma(problem.odo_valid[:, None], problem.odo_sigma),
            _inv_sigma(problem.prior_pose_valid[:, None],
                       problem.prior_pose_sigma),
            _inv_sigma(problem.prior_point_valid, problem.prior_point_sigma))


def _residuals(problem: BAProblem, v: BAVariables):
    p6 = _pose6(v)
    p6o, pts, cal, inv_sig = _gather_obs(problem, v)
    r_obs = factors.obs_residual(p6o, pts, problem.obs_uv, cal, inv_sig)
    inv_odo, inv_pp, inv_qp = _weights(problem)
    r_odo = factors.odo_residual(p6[problem.odo_from], p6[problem.odo_to],
                                 problem.odo_r, problem.odo_t, inv_odo)
    r_pp = factors.prior_pose_residual(p6[problem.prior_pose_idx],
                                       problem.prior_pose_r,
                                       problem.prior_pose_t, inv_pp)
    r_qp = (v.points[problem.prior_point_idx]
            - problem.prior_point_xyz) * inv_qp[:, None]
    return r_obs, r_odo, r_pp, r_qp


def compute_cost(problem: BAProblem, v: BAVariables, axis_name=None):
    """0.5 * the sum of squared whitened residuals (a 0-dim tensor on the
    problem's device; reading it is the caller's host sync)."""
    if axis_name is not None:
        raise ValueError(f"axis_name {_NOT_PORTED}")
    r_obs, r_odo, r_pp, r_qp = _residuals(problem, v)
    return 0.5 * torch.sum(r_obs ** 2) + 0.5 * (
        torch.sum(r_odo ** 2) + torch.sum(r_pp ** 2) + torch.sum(r_qp ** 2))


def linearize(problem: BAProblem, v: BAVariables,
              axis_name=None) -> Linearization:
    """Linearize all factors: residuals, Jacobians, gradients, the point
    blocks Hpp and the pose diagonal."""
    if axis_name is not None:
        raise ValueError(f"axis_name {_NOT_PORTED}")
    F = problem.n_poses
    P = problem.n_points
    p6 = _pose6(v)

    p6o, pts, cal, inv_sig = _gather_obs(problem, v)
    r_obs = factors.obs_residual(p6o, pts, problem.obs_uv, cal, inv_sig)
    Jp6, Jpt = factors.obs_residual_jac(p6o, pts, problem.obs_uv, cal,
                                        inv_sig)

    inv_odo, inv_pp, inv_qp = _weights(problem)
    p6f, p6t = p6[problem.odo_from], p6[problem.odo_to]
    r_odo = factors.odo_residual(p6f, p6t, problem.odo_r, problem.odo_t,
                                 inv_odo)
    Jof, Jot = factors.odo_residual_jac(p6f, p6t, problem.odo_r,
                                        problem.odo_t, inv_odo)
    p6p = p6[problem.prior_pose_idx]
    r_pp = factors.prior_pose_residual(p6p, problem.prior_pose_r,
                                       problem.prior_pose_t, inv_pp)
    Jpp = factors.prior_pose_residual_jac(p6p, problem.prior_pose_r,
                                          problem.prior_pose_t, inv_pp)
    r_qp = (v.points[problem.prior_point_idx]
            - problem.prior_point_xyz) * inv_qp[:, None]

    cost = 0.5 * torch.sum(r_obs ** 2) + 0.5 * (
        torch.sum(r_odo ** 2) + torch.sum(r_pp ** 2) + torch.sum(r_qp ** 2))

    # gradients g = J^T r
    g_pose = _seg(_JTr(Jp6, r_obs), problem.obs_pose, F)
    g_pose = g_pose + _seg(_JTr(Jof, r_odo), problem.odo_from, F)
    g_pose = g_pose + _seg(_JTr(Jot, r_odo), problem.odo_to, F)
    g_pose = g_pose + _seg(_JTr(Jpp, r_pp), problem.prior_pose_idx, F)
    g_point = _seg(_JTr(Jpt, r_obs), problem.obs_point, P)
    g_point = g_point + _seg(r_qp * inv_qp[:, None],
                             problem.prior_point_idx, P)

    # point blocks Hpp (point priors included) and the pose diagonal
    eye3 = torch.eye(3, dtype=r_obs.dtype, device=r_obs.device)
    Hpp = _seg(_JTJ(Jpt), problem.obs_point, P)
    Hpp = Hpp + _seg((inv_qp ** 2)[:, None, None] * eye3[None],
                     problem.prior_point_idx, P)
    diag_pose = _seg(_JTJ_diag(Jp6), problem.obs_pose, F)
    diag_pose = diag_pose + _seg(_JTJ_diag(Jof), problem.odo_from, F)
    diag_pose = diag_pose + _seg(_JTJ_diag(Jot), problem.odo_to, F)
    diag_pose = diag_pose + _seg(_JTJ_diag(Jpp), problem.prior_pose_idx, F)

    # free = marked valid (and, for a point, constrained at all)
    point_free = problem.point_valid & (
        torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1) > 0)
    return Linearization(
        r_obs=r_obs, J_obs_pose=Jp6, J_obs_point=Jpt, r_odo=r_odo,
        J_odo_from=Jof, J_odo_to=Jot, r_pp=r_pp, J_pp=Jpp, r_qp=r_qp,
        cost=cost, g_pose=g_pose, g_point=g_point, Hpp=Hpp,
        diag_pose=diag_pose, pose_free=problem.pose_valid,
        point_free=point_free)


def _w_t_apply(problem: BAProblem, lin: Linearization, v):
    """v [F, 6] -> Hpc v = W^T v [P, 3]."""
    z = _Jv(lin.J_obs_pose, v[problem.obs_pose])
    return _seg(_JTr(lin.J_obs_point, z), problem.obs_point,
                problem.n_points)


def _w_apply(problem: BAProblem, lin: Linearization, u):
    """u [P, 3] -> Hcp u = W u [F, 6]."""
    w = _Jv(lin.J_obs_point, u[problem.obs_point])
    return _seg(_JTr(lin.J_obs_pose, w), problem.obs_pose, problem.n_poses)


def _hpp_damped(lin: Linearization, lam):
    """(solve, inverse) of the damped point blocks Hpp + lam diag(Hpp),
    zero on points that are not free."""
    point_mask = lin.point_free[:, None].to(lin.Hpp.dtype)
    eye3 = torch.eye(3, dtype=lin.Hpp.dtype, device=lin.Hpp.device)
    dp = torch.diagonal(lin.Hpp, dim1=-2, dim2=-1)
    Hpp_d = lin.Hpp + (lam * torch.clamp(dp, min=1e-12))[..., None] * eye3

    def hpp_solve(t):
        return linalg.solve3x3_sym(Hpp_d, t) * point_mask

    return hpp_solve, linalg.inv3x3(Hpp_d) * point_mask[..., None]


def _reduced_system(problem: BAProblem, lin: Linearization, lam, hpp):
    """The damped reduced camera system (S [6F, 6F], b [6F]) for ``hpp =
    _hpp_damped(lin, lam)``: W scattered
    from the per-observation blocks A = Jp^T Jpt into [F*P, 6, 3]
    (``index_add_``), W Hpp^-1 W^T one matrix product, Hcc from its
    diagonal and odometry cross blocks; fixed poses become identity
    rows / columns."""
    F = problem.n_poses
    P = problem.n_points
    # the flat scatter index below is int32
    if F * P >= 2 ** 31:
        raise ValueError(f"dense path scatter index overflows int32 "
                         f"(F*P = {F * P}); the CG path {_NOT_PORTED}")
    n = F * 6
    dev = lin.Hpp.device
    hpp_solve, Hpp_inv = hpp

    # dense W [F, P, 6, 3] from the per-observation blocks
    A = torch.sum(lin.J_obs_pose[:, :, :, None]
                  * lin.J_obs_point[:, :, None, :], dim=1)
    W = _seg(A, problem.obs_pose * P + problem.obs_point,
             F * P).reshape(F, P, 6, 3)
    WH = torch.einsum("fpab,pbc->fpac", W, Hpp_inv)
    S2 = torch.einsum("fpac,gpbc->fagb", WH, W).reshape(n, n)

    # dense Hcc: per-pose diagonal blocks + odometry cross blocks
    Hd = _seg(_JTJ(lin.J_obs_pose), problem.obs_pose, F)
    Hd = Hd + _seg(_JTJ(lin.J_odo_from), problem.odo_from, F)
    Hd = Hd + _seg(_JTJ(lin.J_odo_to), problem.odo_to, F)
    Hd = Hd + _seg(_JTJ(lin.J_pp), problem.prior_pose_idx, F)
    cross = torch.sum(lin.J_odo_from[:, :, :, None]
                      * lin.J_odo_to[:, :, None, :], dim=1)  # [Q, 6, 6]
    diag_idx = torch.arange(F, device=dev, dtype=torch.int32) * (F + 1)
    Hcc = _seg(Hd, diag_idx, F * F)
    Hcc.index_add_(0, problem.odo_from * F + problem.odo_to, cross)
    Hcc.index_add_(0, problem.odo_to * F + problem.odo_from,
                   cross.transpose(-1, -2))
    Hcc = Hcc.reshape(F, F, 6, 6).permute(0, 2, 1, 3).reshape(n, n)

    free6 = torch.repeat_interleave(lin.pose_free, 6)
    diag6 = (lam * torch.clamp(lin.diag_pose, min=1e-12)).reshape(n)
    S = Hcc - S2
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, diag6, 1.0))

    b = -lin.g_pose + _w_apply(problem, lin, hpp_solve(lin.g_point))
    b = (b * lin.pose_free[:, None].to(b.dtype)).reshape(n)
    return S, b


def _cholesky_solve(S, b):
    """x with S x = b: Jacobi equilibration (factor D^-1/2 S D^-1/2, whose
    condition number drops by the scale spread between rotation and
    translation blocks — it matters for a float32 Cholesky on monocular
    BA), ``cholesky_ex``, two triangular solves, two refinement passes.  A
    factorization that fails (``info`` != 0) gives NaN, as XLA's does."""
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-30))
    Ssc = S / (d[:, None] * d[None, :])
    L, info = torch.linalg.cholesky_ex(Ssc)
    L = L + torch.where(info != 0, float("nan"), 0.0)

    def cho_solve(rhs):
        y = torch.linalg.solve_triangular(L, (rhs / d)[:, None],
                                          upper=False)
        x = torch.linalg.solve_triangular(L.transpose(0, 1), y, upper=True)
        return x[:, 0] / d

    x = cho_solve(b)
    # iterative refinement absorbs the float32 factorization's roundoff
    for _ in range(2):
        x = x + cho_solve(b - S @ x)
    return x


def solve_delta_dense(problem: BAProblem, lin: Linearization, lam):
    """Direct dense-Schur solve of the damped normal equations; returns
    (delta_pose [F, 6], delta_point [P, 3]).

    ``lam`` is a float or a 0-dim float32 tensor.  With F poses the reduced
    camera system is [6F, 6F] (``_reduced_system``); it is solved exactly
    (``_cholesky_solve``) and the landmarks back-substituted,
    dp = -(Hpp + lam Dp)^-1 (g_p + W^T dc).  A factorization that fails
    gives a NaN step, which LM rejects."""
    hpp = _hpp_damped(lin, lam)
    with _exact_f32():
        S, b = _reduced_system(problem, lin, lam, hpp)
        x = _cholesky_solve(S, b)
    hpp_solve = hpp[0]
    delta_pose = x.reshape(problem.n_poses, 6) * lin.pose_free[:, None].to(
        x.dtype)
    delta_point = -hpp_solve(lin.g_point
                             + _w_t_apply(problem, lin, delta_pose))
    return delta_pose, delta_point


def apply_delta(v: BAVariables, delta_pose, delta_point) -> BAVariables:
    """Manifold update: poses retract in the body frame (the linearization
    chart of ``factors``), points update additively."""
    R = so3.exp(v.pose_r)
    Rn = matmul_small(R, so3.exp(delta_pose[:, :3]))
    return BAVariables(pose_r=so3.log(Rn),
                       pose_t=v.pose_t + matvec_small(R, delta_pose[:, 3:]),
                       points=v.points + delta_point)


def lm_solve(problem: BAProblem, v0: BAVariables = None, max_iters: int = 60,
             lam0: float = 1e-6, lam_up: float = 8.0, lam_down: float = 2.0,
             cg_iters: int = 1000, cg_tol: float = 1e-10, rtol: float = 0.0,
             method: str = "auto", verbose: bool = False, layout="auto",
             max_retries: int = 6):
    """Levenberg-Marquardt outer loop, accept / reject on the host.

    Linearize once per outer iteration; up to ``max_retries`` solve attempts
    against that linearization, lambda multiplied by ``lam_up`` after a rejected one and
    divided by ``lam_down`` after an accepted one; stop when no attempt
    improves (or, with ``rtol``, when the relative decrease falls below it).
    Each attempt reads its cost on the host.  ``method``: ``"dense"`` or
    ``"auto"`` (dense within ``dense_method_ok``); ``cg_iters`` / ``cg_tol``
    belong to the CG path (not ported) and are ignored.  Returns (v, history
    of costs, one per outer iteration after the initial one)."""
    _check_method(problem, method, layout)
    v = v0 or problem.init
    lam = lam0
    cost = float(compute_cost(problem, v))
    history = [cost]
    for it in range(max_iters):
        lin = linearize(problem, v)
        improved = False
        for _ in range(max_retries):  # lambda escalation attempts
            dc, dp = solve_delta_dense(problem, lin, lam)
            v_try = apply_delta(v, dc, dp)
            new_cost = float(compute_cost(problem, v_try))
            if new_cost < cost:
                v = v_try
                cost = new_cost
                lam = max(lam / lam_down, 1e-9)
                improved = True
                break
            lam = min(lam * lam_up, 1e6)
        history.append(cost)
        if verbose:
            print(f"LM iter {it}: cost={cost:.6e} lam={lam:.2e}")
        if not improved:
            break
        if rtol > 0 and len(history) > 2 and (
                history[-2] - history[-1]) < rtol * max(history[-2], 1e-30):
            break
    return v, history


def lm_solve_device(problem: BAProblem, v0: BAVariables = None,
                    max_iters: int = 60, lam0: float = 1e-6,
                    lam_up: float = 8.0, lam_down: float = 2.0,
                    max_retries: int = 6, cg_iters: int = 1000,
                    cg_tol: float = 1e-10, method: str = "auto",
                    layout="auto"):
    """The JAX package's device-loop entry point, over ``lm_solve``.

    PyTorch has no device ``while_loop``, and a loop that keeps its state on
    the card still reads one accept flag an attempt, as ``lm_solve`` reads
    one cost, so this runs ``lm_solve`` (a fixed grid of masked attempts
    with no read until the end ran slower on the card, ``PERF.md``).
    Returns (v, history_list, n_iters), n_iters the outer iterations run,
    as the JAX package's."""
    v, hist = lm_solve(problem, v0, max_iters=max_iters, lam0=lam0,
                       lam_up=lam_up, lam_down=lam_down,
                       max_retries=max_retries, method=method,
                       layout=layout)
    return v, hist, len(hist) - 1


# alias used by the package __init__
ba_solve = lm_solve
