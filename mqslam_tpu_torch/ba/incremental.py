"""Step-batched incremental bundle adjustment.

The step semantics of the reference's incremental modes (bundle_adjust.cpp
performBundleAdjustment with iSAM1 / iSAM2): factors and variables activate
step by step, newly activated variables start from the front-end estimates
while active ones keep their optimized values, and a few damped
Gauss-Newton iterations run per step (the iSAM update's role); a full LM
runs when the second landmark batch arrives and at the last step.

One padded problem carries per-element activation steps; each step solves
that problem with the later elements masked off, so every step has the
same shapes.  As in the JAX package's host loop, the CG path (``method=
"cg"``) runs over COO, with no layout: the JAX package's masks are traced
data there, which its layout builders cannot read.
"""

import numpy as np
import torch

from mqslam_tpu_torch.ba import solver as bs
from mqslam_tpu_torch.ba.problem import BAProblem

__all__ = ["activation_steps", "incremental_solve",
           "incremental_lockstep", "incremental_solve_device"]


def activation_steps(data, problem: BAProblem):
    """(obs_step [O], odo_step [Q], pose_step [F], point_step [P]) int32
    tensors on the problem's device: the step at which each factor or
    variable enters the graph (int32 max: never)."""
    C = data.nr_cameras
    S = data.nr_steps
    NEVER = np.iinfo(np.int32).max

    pose_valid = problem.pose_valid.cpu().numpy()
    point_valid = problem.point_valid.cpu().numpy()
    P_n = len(data.points3D)

    obs_steps = []
    for c in range(C):
        for s in range(min(S, len(data.point2D3D_assocs[c]))):
            for (f_idx, p2d, p3d) in data.point2D3D_assocs[c][s]:
                f_idx, p3d = int(f_idx), int(p3d)
                if f_idx >= S or not pose_valid[c * S + f_idx]:
                    continue
                if p3d >= P_n or not point_valid[p3d]:
                    continue
                obs_steps.append(s)
    obs_step = np.full(problem.obs_uv.shape[0], NEVER, np.int32)
    obs_step[:len(obs_steps)] = obs_steps

    odo_steps = []
    for s in range(min(S, len(data.odometry_assocs))):
        for (fc, ff, tc, tf) in data.odometry_assocs[s]:
            if ff >= S or tf >= S:
                continue
            if not (pose_valid[fc * S + ff] and pose_valid[tc * S + tf]):
                continue
            odo_steps.append(s)
    odo_step = np.full(problem.odo_r.shape[0], NEVER, np.int32)
    odo_step[:len(odo_steps)] = odo_steps

    pose_step = np.arange(problem.n_poses, dtype=np.int32) % S

    point_step = np.full(problem.n_points, NEVER, np.int32)
    for s in range(S):
        for idx in data.point3D_added_idxs[s]:
            if idx < problem.n_points:
                point_step[idx] = s
    dev = problem.device
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (obs_step, odo_step, pose_step, point_step))


def incremental_solve(data, problem: BAProblem, use_odometry=True,
                      iters_per_step=2, full_lm_iters=10,
                      cg_iters=300, lam0=1e-4, verbose=False,
                      max_steps=None, method="auto", max_retries=5,
                      cg_tol=1e-10):
    """Run the step-batched incremental BA.  Returns (variables, cost
    history: one cost per step).

    The reference's control flow: a full LM (``full_lm_iters``) when the
    second landmark batch appears and at the final step, ``iters_per_step``
    LM iterations otherwise; each iteration tries up to ``max_retries``
    damped steps, lambda halved after an accepted one and multiplied by 8
    after a rejected one, and carried across steps; a step's iterations
    stop at the first that improves nothing.  ``max_steps`` truncates the
    run; ``method`` as in ``lm_solve`` (the CG path over COO, with
    ``cg_iters`` / ``cg_tol``).  The host reads one cost an attempt."""
    vs, histories = incremental_lockstep(
        data, [problem], use_odometry=use_odometry,
        iters_per_step=iters_per_step, full_lm_iters=full_lm_iters,
        cg_iters=cg_iters, lam0=lam0, verbose=verbose, max_steps=max_steps,
        method=method, max_retries=max_retries, cg_tol=cg_tol)
    return vs[0], histories[0]


def incremental_lockstep(data, problems, use_odometry=True,
                         iters_per_step=2, full_lm_iters=10,
                         cg_iters=300, lam0=1e-4, verbose=False,
                         max_steps=None, method="auto", max_retries=5,
                         cg_tol=1e-10):
    """``incremental_solve`` over copies of one problem (on other devices,
    or in another dtype) in lockstep: each copy keeps its own variables and
    costs, and all follow the accept decisions of ``problems[0]``, which
    therefore runs exactly as ``incremental_solve`` runs it.  Returns
    (variables per copy, cost history per copy).

    Near a step's minimum, whether an attempt lowers the float32 cost turns
    on its last bits, so two free runs of the schedule part ways over a few
    steps; in lockstep the copies differ by their arithmetic alone, which
    is what a comparison of two devices has to see."""
    method = bs._resolve_method(problems[0], method)
    steps = [activation_steps(data, p) for p in problems]
    S = data.nr_steps

    def masked(p, act, s):
        obs_step, odo_step, pose_step, point_step = act
        odo_valid = p.odo_valid if use_odometry else \
            torch.zeros_like(p.odo_valid)
        return p._replace(
            obs_valid=p.obs_valid & (obs_step <= s),
            odo_valid=odo_valid & (odo_step <= s),
            pose_valid=p.pose_valid & (pose_step <= s),
            point_valid=p.point_valid & (point_step <= s))

    def solve(ps, lin, lam):
        if method == "dense":
            return bs.solve_delta_dense(ps, lin, lam)
        dc, dp, _ = bs.solve_delta(ps, lin, lam, cg_iters=cg_iters,
                                   cg_tol=cg_tol, layout=None)
        return dc, dp

    # steps with new landmark batches (for the full-LM trigger)
    batch_steps = [s for s in range(S) if data.point3D_added_idxs[s]]
    second_batch = batch_steps[1] if len(batch_steps) > 1 else None

    if max_steps is not None:
        S = min(S, max_steps)
    vs = [p.init for p in problems]
    lam = lam0
    histories = [[] for _ in problems]
    for s in range(S):
        ps = [masked(p, act, s) for p, act in zip(problems, steps)]
        n_iters = full_lm_iters if (s == second_batch or s == S - 1) \
            else iters_per_step
        costs = [float(bs.compute_cost(q, v)) for q, v in zip(ps, vs)]
        for _ in range(n_iters):
            lins = [bs.linearize(q, v) for q, v in zip(ps, vs)]
            accepted = False
            for _ in range(max_retries):
                tries = [bs.apply_delta(v, *solve(q, lin, lam))
                         for q, lin, v in zip(ps, lins, vs)]
                ncs = [float(bs.compute_cost(q, v))
                       for q, v in zip(ps, tries)]
                if ncs[0] < costs[0]:
                    vs, costs = tries, ncs
                    lam = max(lam / 2.0, 1e-9)
                    accepted = True
                    break
                lam = min(lam * 8.0, 1e6)
            if not accepted:
                break
        for history, cost in zip(histories, costs):
            history.append(cost)
        if verbose and (s % 10 == 0 or s == S - 1):
            print(f"incremental step {s}: cost={costs[0]:.4e}")
    return vs, histories


def incremental_solve_device(data, problem: BAProblem, use_odometry=True,
                             iters_per_step=2, full_lm_iters=10,
                             cg_iters=300, lam0=1e-4, max_steps=None,
                             method="auto", max_retries=5, cg_tol=1e-10):
    """The JAX package's device-loop entry point, over
    ``incremental_solve``: PyTorch has no device loop, and the schedule's
    accept decisions are the host's (one cost read an attempt), as in
    ``solver.lm_solve_device``.  Returns (variables, cost history list, per
    step), as the JAX package's."""
    return incremental_solve(data, problem, use_odometry=use_odometry,
                             iters_per_step=iters_per_step,
                             full_lm_iters=full_lm_iters, cg_iters=cg_iters,
                             lam0=lam0, max_steps=max_steps, method=method,
                             max_retries=max_retries, cg_tol=cg_tol)
