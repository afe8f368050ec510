"""Damped Gauss-Newton (LM) over a Schur-complement reduced camera system.

At each outer iteration the problem is linearized once and the landmarks
are marginalized.  Two solvers share that linearization:

- ``solve_delta_dense`` materializes the reduced system

      S = Hcc + lam D - W (Hpp + lam Dp)^-1 W^T

  with one scatter of the per-observation W blocks and one matrix product,
  equilibrates it, Cholesky-factors it and solves exactly, with two passes
  of iterative refinement.  A failed factorization is a rejected LM step,
  as in the JAX package: XLA's Cholesky returns NaN for a matrix that is
  not positive definite; ``cholesky_ex`` reports the failure in ``info``
  and the factor is turned into NaN on the device, with no host read.
- ``solve_delta`` (matrix-free PCG) applies the reduced operator

      B v = (Hcc + lam D) v - Hcp (Hpp + lam Dp)^-1 Hpc v

  without materializing Hcp, over one of three observation layouts: COO
  (per-observation gathers and ``index_add_`` segment sums), the packed
  dual layout (``ba/packed.py``) or the gather-free banded grid
  (``ba/banded.py``); CG is preconditioned with the exact per-pose 6x6
  diagonal blocks of S (block Jacobi).  It serves problems past the dense
  path's size gates (``dense_method_ok``).

Landmark increments come from closed-form damped 3x3 back-substitution in
both.  Every operation is a PyTorch library call: the JAX package's
``segment_sum`` is ``index_add_``, its HIGHEST-precision products
``einsum`` / ``bmm`` with TF32 off (``_exact_f32``), its ``cholesky`` /
``solve_triangular`` ``torch.linalg.cholesky_ex`` / ``solve_triangular``,
its CG ``while_loop`` a host loop whose state stays on the device (see
``solve_delta``).

Sharded solves: where the JAX package takes a mesh ``axis_name`` (inside
``shard_map``), these functions take ``group``, a ``torch.distributed``
process group.  Each rank then holds its own slice of the observation rows
(``parallel.sharded_ba``), pose and landmark vectors stay replicated, and
every ``psum`` of the JAX package is an ``all_reduce`` (SUM) over the group
of a freshly computed partial (``_psum``).  ``group=None`` is the
single-device path.
"""

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from mqslam_tpu_torch.ba import factors
from mqslam_tpu_torch.ba.banded import (BandedLayout, _Hooks, banded_hooks,
                                        banded_hooks_sharded,
                                        build_banded_layout, pack_banded,
                                        pack_banded_sharded,
                                        ShardedBandedLayout)
from mqslam_tpu_torch.ba.packed import (apply_chunked, build_packed_layout,
                                        PackedLayout, ShardedPackedLayout)
from mqslam_tpu_torch.ba.problem import BAProblem, BAVariables
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.core.smallmat import matmul_small, matvec_small
from mqslam_tpu_torch.ops import linalg
from mqslam_tpu_torch.utils import profiling

__all__ = ["dense_method_ok", "Linearization", "linearize", "solve_delta",
           "solve_delta_dense", "pack_jacobians", "pack_for_layout",
           "apply_delta", "compute_cost", "lm_solve", "lm_solve_device",
           "ba_solve"]

# Auto-method gates of the dense-Schur path.  Besides the [6F, 6F] reduced
# system, solve_delta_dense materializes two [F*P, 6, 3] float32 transients
# (W and WH), O(F*P) memory whatever F, so "auto" also bounds F*P; the same
# bound keeps the flat int32 scatter index obs_pose * P + obs_point well
# inside 2^31.
_DENSE_MAX_POSE_DIM = 4096
_DENSE_MAX_FP = 8 * 1024 * 1024

# The CG loop reads its stop flag on the host every CG_CHECK_EVERY
# iterations; in between, iterations past the stop are computed and frozen
# on the device, so the result equals a loop that stopped at once.
CG_CHECK_EVERY = 10


def dense_method_ok(problem: BAProblem) -> bool:
    """True when solve_delta_dense is safe and sensible for this size."""
    return (problem.n_poses * 6 <= _DENSE_MAX_POSE_DIM
            and problem.n_poses * problem.n_points <= _DENSE_MAX_FP)


def _resolve_method(problem, method):
    """``"auto"`` -> dense within ``dense_method_ok``, else CG."""
    if method == "auto":
        return "dense" if dense_method_ok(problem) else "cg"
    if method not in ("dense", "cg"):
        raise ValueError(f"method={method!r}: 'auto', 'dense' or 'cg'")
    return method


def _auto_layout(problem: BAProblem):
    """Host-side layout build for the CG path: the gather-free banded grid
    when it builds, else the packed dual layout, else None (COO)."""
    args = (problem.obs_pose, problem.obs_point, problem.obs_valid,
            problem.n_poses, problem.n_points)
    bl = build_banded_layout(*args)
    return bl if bl is not None else build_packed_layout(*args)


def _resolve_layout(problem, method, layout):
    """``"auto"`` -> ``_auto_layout`` for CG, None for dense; else a built
    layout or None."""
    if isinstance(layout, str):
        if layout != "auto":
            raise ValueError(f"layout={layout!r}: 'auto', None or a built "
                             "PackedLayout / BandedLayout")
        return _auto_layout(problem) if method == "cg" else None
    return layout


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


def _psum(x, group):
    """``jax.lax.psum`` over ``group``: every rank's ``x`` summed, in place
    in ``x`` and returned; ``x`` itself when ``group`` is None.  ``x`` must
    be a fresh partial that nothing else reads.  A group of one rank still
    runs the collective."""
    if group is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


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


def compute_cost(problem: BAProblem, v: BAVariables, group=None):
    """0.5 * the sum of squared whitened residuals (a 0-dim tensor on the
    problem's device; reading it is the caller's host sync).  With
    ``group`` (the JAX package's ``axis_name``) the observation rows are
    this rank's and their partial sum is reduced over the group."""
    r_obs, r_odo, r_pp, r_qp = _residuals(problem, v)
    c_obs = _psum(0.5 * torch.sum(r_obs ** 2), group)
    return c_obs + 0.5 * (
        torch.sum(r_odo ** 2) + torch.sum(r_pp ** 2) + torch.sum(r_qp ** 2))


def linearize(problem: BAProblem, v: BAVariables,
              group=None) -> Linearization:
    """Linearize all factors: residuals, Jacobians, gradients, the point
    blocks Hpp and the pose diagonal.  With ``group`` (the JAX package's
    ``axis_name``) the observation rows are this rank's: their cost,
    gradients, point blocks and pose diagonal are partial sums, reduced over
    the group in one all-reduce; odometry and prior terms are replicated."""
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

    # observation partial aggregates (this rank's rows under a group),
    # reduced in one all-reduce of their concatenation
    obs_parts = (0.5 * torch.sum(r_obs ** 2)[None],
                 _seg(_JTr(Jp6, r_obs), problem.obs_pose, F),
                 _seg(_JTr(Jpt, r_obs), problem.obs_point, P),
                 _seg(_JTJ(Jpt), problem.obs_point, P),
                 _seg(_JTJ_diag(Jp6), problem.obs_pose, F))
    if group is not None:
        flat = _psum(torch.cat([x.reshape(-1) for x in obs_parts]), group)
        obs_parts = [y.reshape(x.shape) for x, y in zip(
            obs_parts, flat.split([x.numel() for x in obs_parts]))]
    cost_obs, g_pose_obs, g_point_obs, Hpp_obs, diag_obs = obs_parts

    cost = cost_obs[0] + 0.5 * (
        torch.sum(r_odo ** 2) + torch.sum(r_pp ** 2) + torch.sum(r_qp ** 2))

    # gradients g = J^T r
    g_pose = g_pose_obs + _seg(_JTr(Jof, r_odo), problem.odo_from, F)
    g_pose = g_pose + _seg(_JTr(Jot, r_odo), problem.odo_to, F)
    g_pose = g_pose + _seg(_JTr(Jpp, r_pp), problem.prior_pose_idx, F)
    g_point = g_point_obs + _seg(r_qp * inv_qp[:, None],
                                 problem.prior_point_idx, P)

    # point blocks Hpp (point priors included) and the pose diagonal
    eye3 = torch.eye(3, dtype=r_obs.dtype, device=r_obs.device)
    Hpp = Hpp_obs + _seg((inv_qp ** 2)[:, None, None] * eye3[None],
                         problem.prior_point_idx, P)
    diag_pose = diag_obs + _seg(_JTJ_diag(Jof), problem.odo_from, F)
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


def _w_t_apply(problem: BAProblem, lin: Linearization, v, group=None):
    """v [F, 6] -> Hpc v = W^T v [P, 3] (summed over ``group``)."""
    z = _Jv(lin.J_obs_pose, v[problem.obs_pose])
    return _psum(_seg(_JTr(lin.J_obs_point, z), problem.obs_point,
                      problem.n_points), group)


def _w_apply(problem: BAProblem, lin: Linearization, u, group=None):
    """u [P, 3] -> Hcp u = W u [F, 6] (summed over ``group``)."""
    w = _Jv(lin.J_obs_point, u[problem.obs_point])
    return _psum(_seg(_JTr(lin.J_obs_pose, w), problem.obs_pose,
                      problem.n_poses), group)


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


def _hcc_rest(problem: BAProblem, lin: Linearization, v):
    """v [F, 6] -> (odometry + prior) part of Hcc v — O(F), layout-free."""
    F = problem.n_poses
    yo = (_Jv(lin.J_odo_from, v[problem.odo_from])
          + _Jv(lin.J_odo_to, v[problem.odo_to]))
    out = _seg(_JTr(lin.J_odo_from, yo), problem.odo_from, F)
    out = out + _seg(_JTr(lin.J_odo_to, yo), problem.odo_to, F)
    yp = _Jv(lin.J_pp, v[problem.prior_pose_idx])
    return out + _seg(_JTr(lin.J_pp, yp), problem.prior_pose_idx, F)


def _hcc_obs(problem: BAProblem, lin: Linearization, v, group=None):
    """v [F, 6] -> projection part of Hcc v (COO; summed over ``group``)."""
    y = _Jv(lin.J_obs_pose, v[problem.obs_pose])
    return _psum(_seg(_JTr(lin.J_obs_pose, y), problem.obs_pose,
                      problem.n_poses), group)


def _hcc_apply(problem: BAProblem, lin: Linearization, v, group=None):
    """v [F, 6] -> Hcc v (projection + odometry + prior parts, undamped);
    the projection part summed over ``group``."""
    return _hcc_obs(problem, lin, v, group) + _hcc_rest(problem, lin, v)


def _pad0(a):
    """``a`` with one zero row appended: the row sentinel ids index."""
    return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])


def pack_jacobians(lin: Linearization, layout: PackedLayout):
    """Gather the per-observation Jacobians into the dual dense layout, once
    per linearization: BOTH Jacobians land in BOTH layouts, so every cross
    product contracts in place and only the [F, 6] / [P, 3] state vectors
    are gathered in the CG loop.  The 5th entry is the per-pose observation
    Gram G_f = sum_k Jp^T Jp [F, 6, 6]: the CG iteration's Hcc-obs leg is
    exactly G_f @ v_f."""
    Jp_f = _pad0(lin.J_obs_pose)[layout.fslot]      # [F, Kf, 2, 6]
    with _exact_f32():
        G = torch.einsum("fkcx,fkcy->fxy", Jp_f, Jp_f)
    return (Jp_f,
            _pad0(lin.J_obs_point)[layout.fslot],   # [F, Kf, 2, 3]
            _pad0(lin.J_obs_point)[layout.pslot],   # [P, Kp, 2, 3]
            _pad0(lin.J_obs_pose)[layout.pslot],    # [P, Kp, 2, 6]
            G)


def _pack_dispatch(lin: Linearization, layout, group=None):
    """The per-linearization tables of whichever CG layout is in play: a
    rank's sharded banded block (``banded.pack_banded_sharded``, its Grams
    summed over ``group``), the banded grid's (``banded.pack_banded``) or
    the packed layout's, single-device or one rank's sharded block
    (``pack_jacobians``)."""
    with _exact_f32():
        if isinstance(layout, ShardedBandedLayout):
            return pack_banded_sharded(lin, layout, group)
        if isinstance(layout, BandedLayout):
            return pack_banded(lin, layout)
    return pack_jacobians(lin, layout)


# the JAX package's name for its jitted ``_pack_dispatch``
pack_for_layout = _pack_dispatch


def _packed_ops(problem: BAProblem, lin: Linearization, layout: PackedLayout,
                packedJ=None):
    """Dense applies for the CG loop over the packed layout: block products
    plus at most one gather of the small [F, 6] / [P, 3] state vector
    (``fid_p`` / ``pid_f`` row ids, through ``apply_chunked`` where the
    layout has its pack-row form); no scatter.  Padding slots index the
    appended zero rows and contribute nothing.  Returns (hcc_obs, wt_from_v,
    w_apply, precond_obs_blocks); call them with TF32 off."""
    Jp_f, Jt_f, Jt_p, Jp_p, G = (pack_jacobians(lin, layout)
                                 if packedJ is None else packedJ)

    def hcc_obs_v(v):                            # [F, 6] -> [F, 6]
        return torch.bmm(G, v[:, :, None])[:, :, 0]

    def gather_f(v):                             # v[fid_p] -> [P, Kp, 6]
        if layout.wg_fid is not None:
            return apply_chunked(layout.wg_fid, v)
        return _pad0(v)[layout.fid_p]

    def gather_p(u):                             # u[pid_f] -> [F, Kf, 3]
        if layout.wg_pid is not None:
            return apply_chunked(layout.wg_pid, u)
        return _pad0(u)[layout.pid_f]

    def wt_from_v(v):                            # [F, 6] -> [P, 3]
        z = torch.einsum("pkcx,pkx->pkc", Jp_p, gather_f(v))
        return torch.einsum("pkcy,pkc->py", Jt_p, z)

    def w_apply(u):                              # [P, 3] -> [F, 6]
        w = torch.einsum("fkcy,fky->fkc", Jt_f, gather_p(u))
        return torch.einsum("fkcx,fkc->fx", Jp_f, w)

    def precond_obs_blocks(Hpp_inv):             # -> [F, 6, 6]
        Hj = _pad0(Hpp_inv)[layout.pid_f]                    # [F, Kf, 3, 3]
        A = torch.sum(Jp_f[:, :, :, :, None] * Jt_f[:, :, :, None, :],
                      dim=2)                                 # [F, Kf, 6, 3]
        return G - torch.sum(_aha(A, Hj), dim=1)  # JJ term == the Gram

    return hcc_obs_v, wt_from_v, w_apply, precond_obs_blocks


def _packed_ops_rows(problem: BAProblem, lin: Linearization, layout,
                     packedJ=None):
    """Packed applies for one rank's block of a ``ShardedPackedLayout``
    (``packed.layout_shard``).

    ``_packed_ops``' dense math, but the tables cover only this rank's Fd
    poses / Pd landmarks: replicated [F, 6] / [P, 3] vectors are gathered
    down through the row maps, partial results scatter-add back through
    them ([Fd, 6] rows, 2-3 orders fewer than the COO form's
    per-observation scatters).  Outputs are PARTIAL sums: the caller
    reduces them over the group.  Also valid on one device (no
    reduction).  Call them with TF32 off."""
    F = problem.n_poses
    P = problem.n_points
    Jp_f, Jt_f, Jt_p, Jp_p, G = (pack_jacobians(lin, layout)
                                 if packedJ is None else packedJ)

    def scat_f(part):                            # [Fd, x] -> [F, x] partial
        return _seg(part, layout.rows_f, F + 1)[:F]

    def scat_p(part):                            # [Pd, x] -> [P, x] partial
        return _seg(part, layout.rows_p, P + 1)[:P]

    def hcc_obs_v(v):                            # [F, 6] -> [F, 6] partial
        vloc = _pad0(v)[layout.rows_f]           # [Fd, 6] (local Gram)
        return scat_f(torch.bmm(G, vloc[:, :, None])[:, :, 0])

    def wt_from_v(v):                            # [F, 6] -> [P, 3]
        z = torch.einsum("pkcx,pkx->pkc", Jp_p, _pad0(v)[layout.fid_p])
        return scat_p(torch.einsum("pkcy,pkc->py", Jt_p, z))

    def w_apply(u):                              # [P, 3] -> [F, 6]
        w = torch.einsum("fkcy,fky->fkc", Jt_f, _pad0(u)[layout.pid_f])
        return scat_f(torch.einsum("fkcx,fkc->fx", Jp_f, w))

    def precond_obs_blocks(Hpp_inv):             # -> [F, 6, 6]
        Hj = _pad0(Hpp_inv)[layout.pid_f]                    # [Fd,Kf,3,3]
        A = torch.sum(Jp_f[:, :, :, :, None] * Jt_f[:, :, :, None, :],
                      dim=2)                                 # [Fd,Kf,6,3]
        return scat_f(G - torch.sum(_aha(A, Hj), dim=1))  # JJ == local Gram

    return hcc_obs_v, wt_from_v, w_apply, precond_obs_blocks


def _aha(A, Hj):
    """A Hj A^T for W blocks A [..., 6, 3] and point blocks Hj [..., 3, 3],
    as broadcast + sum in the JAX package's order: Hj is ill-conditioned
    for weakly constrained landmarks, its terms cancel, and this order
    keeps every layout's preconditioner blocks within float32 roundoff of
    each other (a library product sums the same terms in another order)."""
    AH = torch.sum(A[..., :, :, None] * Hj[..., None, :, :], dim=-2)
    return torch.sum(AH[..., :, None, :] * A[..., None, :, :], dim=-1)


def _coo_precond_obs_blocks(problem: BAProblem, lin: Linearization, Hpp_inv):
    """Observation part of the exact 6x6 diagonal blocks of S, COO form:
    per observation the W block A = Jp^T Jpt [O, 6, 3] and its Schur
    correction A Hpp_j^-1 A^T, summed per pose."""
    A = torch.sum(lin.J_obs_pose[:, :, :, None]
                  * lin.J_obs_point[:, :, None, :], dim=1)
    AHA = _aha(A, Hpp_inv[problem.obs_point])              # [O, 6, 6]
    return _seg(_JTJ(lin.J_obs_pose) - AHA, problem.obs_pose,
                problem.n_poses)


def _layout_hooks(problem, lin, layout, packedJ, hpp_solve, Hpp_inv,
                  group=None):
    """(hcc_obs, corr, w_full, wt_full, pre) of the reduced operator over
    ``layout``: the Hcc projection part, W M W^T, W, W^T and the
    observation part of the preconditioner blocks, where M is the damped
    point-block inverse; each summed over ``group`` where it has one.
    Call them with TF32 off."""
    if isinstance(layout, ShardedBandedLayout):
        if group is None and layout.Fb != layout.F:
            raise ValueError("a block of a sharded banded layout of more "
                             "than one rank needs its process group")
        return banded_hooks_sharded(problem, lin, layout, packedJ, Hpp_inv,
                                    group)
    if group is not None and isinstance(layout, (BandedLayout,
                                                 PackedLayout)):
        raise ValueError(
            f"a {type(layout).__name__} is single-device; shard with "
            "ba.packed.build_sharded_packed_layout or ba.banded."
            "build_sharded_banded_layout for a solve over a group")
    if isinstance(layout, BandedLayout):
        return banded_hooks(problem, lin, layout, packedJ, Hpp_inv)
    if layout is not None:
        ops = (_packed_ops_rows if isinstance(layout, ShardedPackedLayout)
               else _packed_ops)
        hcc, wt_v, w_ap, pre_obs = ops(problem, lin, layout, packedJ)
        ps = lambda f: (lambda x: _psum(f(x), group))
        hcc, wt_v, w_ap = ps(hcc), ps(wt_v), ps(w_ap)
        return _Hooks(hcc=hcc, corr=lambda v: w_ap(hpp_solve(wt_v(v))),
                      w_full=w_ap, wt_full=wt_v,
                      pre=lambda: _psum(pre_obs(Hpp_inv), group))
    return _Hooks(
        hcc=lambda v: _hcc_obs(problem, lin, v, group),
        corr=lambda v: _w_apply(problem, lin,
                                hpp_solve(_w_t_apply(problem, lin, v,
                                                     group)), group),
        w_full=lambda t: _w_apply(problem, lin, t, group),
        wt_full=lambda v: _w_t_apply(problem, lin, v, group),
        pre=lambda: _psum(_coo_precond_obs_blocks(problem, lin, Hpp_inv),
                          group))


def solve_delta(problem: BAProblem, lin: Linearization, lam,
                cg_iters: int = 100, cg_tol: float = 1e-6, group=None,
                layout=None, packedJ=None):
    """Solve the damped normal equations by matrix-free Schur PCG.

    Returns (delta_pose [F, 6], delta_point [P, 3], cg_iters_used, a 0-dim
    int32 tensor on the device).  ``layout``: None (COO), a
    ``PackedLayout`` or a ``BandedLayout``; ``packedJ`` its
    ``pack_for_layout`` tables, or None to pack here.  The reduced camera
    system is solved by CG preconditioned with its exact per-pose 6x6
    diagonal blocks (block Jacobi): with one observation per (pose, point)
    pair, diag_blk(S)_f = sum_obs Jp^T Jp + odometry / prior blocks +
    damping - sum_obs A (Hpp + lam Dp)^-1 A^T, A = Jp^T Jpt, exactly.  With
    a duplicated pair the blocks are no longer exact and CG converges more
    slowly, to the same solution over COO and the packed layout (the
    banded builder refuses such a problem).

    CG stops once ||r|| <= cg_tol * ||b|| or after ``cg_iters``
    iterations, as the JAX package's ``while_loop``.  Its state stays on
    the device: an iteration past the stop is computed and discarded by
    ``torch.where``, so x, r and the count equal those of a loop that
    stopped, and the host reads the stop flag every ``CG_CHECK_EVERY``
    iterations only.

    ``group`` (the JAX package's ``axis_name``): the problem's observation
    rows and ``lin`` are this rank's; ``layout`` None (COO) or this rank's
    block of a ``ShardedPackedLayout`` / ``ShardedBandedLayout``
    (``packed.layout_shard``); every observation sum is reduced over the
    group (the rhs, each matvec, the preconditioner blocks and the
    back-substitution), so every rank iterates on the same replicated
    vectors and stops at the same iteration."""
    F = problem.n_poses
    dt = lin.g_pose.dtype
    pose_mask = lin.pose_free[:, None].to(dt)
    hpp_solve, Hpp_inv = _hpp_damped(lin, lam)
    damp = lam * torch.clamp(lin.diag_pose, min=1e-12)          # [F, 6]
    eye6 = torch.eye(6, dtype=dt, device=lin.g_pose.device)

    with _exact_f32():
        hooks = _layout_hooks(problem, lin, layout, packedJ, hpp_solve,
                              Hpp_inv, group)

        def B_apply(vv):
            vv = vv * pose_mask
            hv = hooks.hcc(vv) + _hcc_rest(problem, lin, vv) + damp * vv
            return (hv - hooks.corr(vv)) * pose_mask

        # reduced RHS: -g_c + W Hpp^-1 g_p
        b = (-lin.g_pose + hooks.w_full(hpp_solve(lin.g_point))) * pose_mask

        # block-Jacobi preconditioner: the exact 6x6 diagonal blocks of B
        blk = hooks.pre()
        blk = blk + _seg(_JTJ(lin.J_odo_from), problem.odo_from, F)
        blk = blk + _seg(_JTJ(lin.J_odo_to), problem.odo_to, F)
        blk = blk + _seg(_JTJ(lin.J_pp), problem.prior_pose_idx, F)
        blk = blk + damp[:, :, None] * eye6
        blk = torch.where(lin.pose_free[:, None, None], blk, eye6)

        def Minv_apply(rr):
            return linalg.solve6x6_spd(blk, rr) * pose_mask

        bb = torch.sum(b * b)
        thr = cg_tol ** 2 * bb
        x, r = torch.zeros_like(b), b
        z = Minv_apply(b)
        p, rz = z, torch.sum(b * z)
        it = torch.zeros((), dtype=torch.int32, device=b.device)
        done = ~(torch.sum(r * r) > thr)
        for k in range(cg_iters):
            if k % CG_CHECK_EVERY == 0 and bool(done):
                break
            Ap = B_apply(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 1e-30, rz / pAp, 0.0)
            x2 = x + alpha * p
            r2 = r - alpha * Ap
            z2 = Minv_apply(r2)
            rz2 = torch.sum(r2 * z2)
            beta = torch.where(rz > 1e-30, rz2 / rz, 0.0)
            p2 = z2 + beta * p
            go = ~done
            x, r, z = (torch.where(go, x2, x), torch.where(go, r2, r),
                       torch.where(go, z2, z))
            p, rz = torch.where(go, p2, p), torch.where(go, rz2, rz)
            it = it + go.to(torch.int32)
            done = done | ~(torch.sum(r * r) > thr)
        delta_pose = x * pose_mask

        # back-substitute landmarks: dp = -Hpp^-1 (g_p + W^T dc)
        delta_point = -hpp_solve(lin.g_point + hooks.wt_full(delta_pose))
    return delta_pose, delta_point, it


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
                         f"(F*P = {F * P}); use method='cg'")
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

    Linearize once per outer iteration (and, on the CG path over a layout,
    pack its tables once: ``pack_for_layout``); up to ``max_retries`` solve
    attempts against that linearization, lambda multiplied by ``lam_up``
    after a rejected one and divided by ``lam_down`` after an accepted one;
    stop when no attempt improves (or, with ``rtol``, when the relative
    decrease falls below it).  Each attempt reads its cost on the host.

    ``method``: ``"dense"`` (``solve_delta_dense``), ``"cg"``
    (``solve_delta`` with ``cg_iters`` / ``cg_tol``) or ``"auto"``, dense
    within ``dense_method_ok``, else CG.  ``layout`` (CG only): ``"auto"``
    (``_auto_layout``: banded, else packed, else COO), None (COO) or a
    built layout.  Weakly constrained SLAM chains have long, nearly flat
    valleys that only near-exact Newton steps walk to the right basin, so
    the CG defaults are a high iteration budget and a tight tolerance.
    Returns (v, history of costs, one per outer iteration after the
    initial one).

    Spans (``utils/profiling.span``, none of which synchronizes):
    ``ba.lm`` the whole solve, ``ba.linearize`` each outer iteration's
    linearization (and packing), ``ba.step`` each attempt's solve and
    update (its count is the attempts'), ``ba.cost`` each cost and its
    read to the host, the initial one included."""
    method = _resolve_method(problem, method)
    layout = _resolve_layout(problem, method, layout)
    dev = problem.device
    v = v0 or problem.init
    with profiling.span("ba.lm", dev):
        lam = lam0
        cost = _cost_read(problem, v, dev)
        history = [cost]
        for it in range(max_iters):
            with profiling.span("ba.linearize", dev):
                lin = linearize(problem, v)
                pJ = (pack_for_layout(lin, layout)
                      if layout is not None and method == "cg" else None)
            improved = False
            for _ in range(max_retries):  # lambda escalation attempts
                with profiling.span("ba.step", dev):
                    if method == "dense":
                        dc, dp = solve_delta_dense(problem, lin, lam)
                    else:
                        dc, dp, _ = solve_delta(
                            problem, lin, lam, cg_iters=cg_iters,
                            cg_tol=cg_tol, layout=layout, packedJ=pJ)
                    v_try = apply_delta(v, dc, dp)
                new_cost = _cost_read(problem, v_try, dev)
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
            if rtol > 0 and len(history) > 2 and (history[-2] - history[-1]
                                                  < rtol * max(history[-2],
                                                               1e-30)):
                break
        return v, history


def _cost_read(problem, v, dev):
    """``compute_cost`` read to the host, as span ``ba.cost``."""
    with profiling.span("ba.cost", dev, drained=True):
        return float(compute_cost(problem, v))


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
                       max_retries=max_retries, cg_iters=cg_iters,
                       cg_tol=cg_tol, method=method, layout=layout)
    return v, hist, len(hist) - 1


# alias used by the package __init__
ba_solve = lm_solve
