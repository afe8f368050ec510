"""Sharded bundle adjustment over a ``torch.distributed`` process group.

The JAX package runs one LM iteration inside a ``shard_map`` region over a
mesh axis: the projection-factor arrays are split along the axis, every
segment sum over poses / landmarks becomes a partial sum followed by a
``psum``, and the CG loop iterates on replicated [F, 6] pose vectors, so
the collective traffic of an iteration is O(poses + landmarks), whatever
the number of observations a device holds.

Here one process (rank) drives one device.  Every rank holds the same
replicated problem on the host, pads its observation rows to a multiple of
the group's size (``pad_problem_for_shards``) and keeps rows
``[r*per, (r+1)*per)`` on its device (``shard_problem_for_mesh``); the
layouts are built on the host from the padded replicated problem and each
rank keeps its own block (``build_layout_for_mesh``,
``build_banded_for_mesh``).  ``ba.solver``'s functions then take the group
(the JAX package's ``axis_name``) and reduce every observation partial
with ``all_reduce``.  Accept / reject decisions read only reduced costs,
so every rank takes the same ones.

Multi-agent mapping: each agent's (camera's) factors are rows of the same
observation arrays (pose index cam * S + frame), so a joint multi-agent
problem shards like any other (BASELINE configs #4 / #5).
"""

import torch
import torch.distributed as dist

from mqslam_tpu_torch.ba import solver as ba_solver
from mqslam_tpu_torch.ba.banded import (build_sharded_banded_layout,
                                        permute_obs)
from mqslam_tpu_torch.ba.packed import (build_sharded_packed_layout,
                                        layout_shard)
from mqslam_tpu_torch.ba.problem import BAProblem

__all__ = ["pad_problem_for_shards", "shard_problem_for_mesh",
           "local_rows", "build_layout_for_mesh", "build_banded_for_mesh",
           "make_sharded_lm_iteration", "sharded_lm_solve",
           "sharded_lm_solve_device"]

_OBS_FIELDS = ("obs_uv", "obs_pose", "obs_cam", "obs_point", "obs_sigma",
               "obs_valid")


def _rank_world(group):
    """(rank, number of ranks) of ``group``; (0, 1) for None, the
    single-device path."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def pad_problem_for_shards(problem: BAProblem, n: int) -> BAProblem:
    """Pad the observation arrays to a multiple of ``n`` with inert rows
    (invalid, sigma 1).  Host-local: every rank pads the same replicated
    problem the same way."""
    O = problem.obs_uv.shape[0]
    pad = -O % n
    if pad == 0:
        return problem
    fields = {f: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
              for f, a in ((f, getattr(problem, f)) for f in _OBS_FIELDS)}
    fields["obs_sigma"][O:] = 1.0
    return problem._replace(**fields)


def local_rows(problem: BAProblem, rank: int, world: int) -> BAProblem:
    """Rank ``rank`` of ``world``'s problem: the observation rows
    ``[rank*per, (rank+1)*per)`` of the problem padded to a multiple of
    ``world``, every other field replicated.  The explicit form of
    ``shard_problem_for_mesh``, for a caller with no process group."""
    problem = pad_problem_for_shards(problem, world)
    per = problem.obs_uv.shape[0] // world
    return problem._replace(**{
        f: getattr(problem, f)[rank * per:(rank + 1) * per]
        for f in _OBS_FIELDS})


def shard_problem_for_mesh(problem: BAProblem, group) -> BAProblem:
    """This rank's local problem (``local_rows`` for the group's rank and
    size), on the problem's device."""
    return local_rows(problem, *_rank_world(group))


def build_layout_for_mesh(problem: BAProblem, group):
    """This rank's block of the compact per-rank packed layout
    (``ba.packed.build_sharded_packed_layout``), built on the host from the
    PADDED replicated problem (``pad_problem_for_shards``) and placed on the
    problem's device.  None when the builder refuses (degenerate observation
    distributions): COO applies then."""
    rank, world = _rank_world(group)
    layout = build_sharded_packed_layout(
        problem.obs_pose, problem.obs_point, problem.obs_valid,
        problem.n_poses, problem.n_points, world, device="cpu")
    if layout is None:
        return None
    return layout_shard(layout, rank, problem.device)


def build_banded_for_mesh(problem: BAProblem, group):
    """The sharded BANDED grid: gather-free pose-block CG legs with one
    all-reduce a matvec (``ba/banded.py``).  The grid needs the observation
    arrays permuted into device-major base-pose blocks, so on success this
    returns (this rank's layout block, the permuted padded replicated
    problem); None when the grid builder refuses (use the packed layout)."""
    rank, world = _rank_world(group)
    out = build_sharded_banded_layout(
        problem.obs_pose, problem.obs_point, problem.obs_valid,
        problem.n_poses, problem.n_points, world, device="cpu")
    if out is None:
        return None
    layout, perm, valid = out
    return (layout_shard(layout, rank, problem.device),
            permute_obs(problem, perm, valid))


def make_sharded_lm_iteration(group, cg_iters: int = 200,
                              cg_tol: float = 1e-10):
    """The sharded LM iteration (local problem, v, lam, layout=None) ->
    (delta_pose, delta_point, cost), every output replicated: linearize
    over ``group``, then the Schur-CG ``solve_delta`` over this rank's
    block of a ``ShardedPackedLayout`` / ``ShardedBandedLayout`` (dense
    row-mapped matvecs, ``solver._packed_ops_rows``, or the banded grid's
    gather-free legs) or, with no layout, over the COO rows."""
    def iteration(problem, v, lam, layout=None):
        lin = ba_solver.linearize(problem, v, group=group)
        dc, dp, _ = ba_solver.solve_delta(problem, lin, lam,
                                          cg_iters=cg_iters, cg_tol=cg_tol,
                                          group=group, layout=layout)
        return dc, dp, lin.cost

    return iteration


def _sharded_cost(group):
    """(local problem, v) -> the cost, its observation part summed over
    ``group``."""
    return lambda problem, v: ba_solver.compute_cost(problem, v, group)


def sharded_lm_solve(problem: BAProblem, group=None, max_iters: int = 40,
                     lam0: float = 1e-6, cg_iters: int = 1000,
                     verbose: bool = False, layout="auto"):
    """LM outer loop over the sharded iteration (host accept / reject).

    Semantics of ``ba.solver.lm_solve``; the observation rows shard over
    ``group`` (the JAX package's mesh axis; None: one device, no
    collective, the single-device path).  Every rank calls this with the
    SAME replicated ``problem``.  ``layout="auto"`` takes the sharded
    banded grid, else the sharded packed layout, else COO (the JAX
    package's order); None forces COO; a built layout (this rank's block)
    is used as given, with the problem it was built for.  The local problem
    lives on the problem's device.  Returns (v, history of costs), v
    replicated on every rank."""
    _, world = _rank_world(group)
    padded = pad_problem_for_shards(problem, world)
    if isinstance(layout, str):
        if layout != "auto":
            raise ValueError(f"layout={layout!r}: 'auto', None or a built "
                             "sharded layout block")
        out = build_banded_for_mesh(padded, group)
        if out is not None:
            layout, padded = out
        else:
            layout = build_layout_for_mesh(padded, group)
    problem = shard_problem_for_mesh(padded, group)
    lm_iter = make_sharded_lm_iteration(group, cg_iters=cg_iters)
    cost_fn = _sharded_cost(group)

    v = problem.init
    lam = lam0
    cost = float(cost_fn(problem, v))
    history = [cost]
    for it in range(max_iters):
        improved = False
        for _ in range(6):
            dc, dp, _ = lm_iter(problem, v, lam, layout)
            v_try = ba_solver.apply_delta(v, dc, dp)
            nc = float(cost_fn(problem, v_try))
            if nc < cost:
                v, cost = v_try, nc
                lam = max(lam / 2.0, 1e-9)
                improved = True
                break
            lam = min(lam * 8.0, 1e6)
        history.append(cost)
        if verbose:
            print(f"sharded LM iter {it}: cost={cost:.6e} lam={lam:.2e}")
        if not improved:
            break
    return v, history


def sharded_lm_solve_device(problem: BAProblem, group=None,
                            max_iters: int = 40, lam0: float = 1e-6,
                            cg_iters: int = 1000, layout="auto"):
    """The JAX package's device-loop entry point, over ``sharded_lm_solve``.

    As ``ba.solver.lm_solve_device`` wraps ``lm_solve``: PyTorch has no
    device ``while_loop``, and each attempt's accept decision reads a
    reduced cost on the host either way.  Returns (v, history_list,
    n_iters), n_iters the outer iterations run."""
    v, hist = sharded_lm_solve(problem, group, max_iters=max_iters,
                               lam0=lam0, cg_iters=cg_iters, layout=layout)
    return v, hist, len(hist) - 1
