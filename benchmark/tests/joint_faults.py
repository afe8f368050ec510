"""The program broken underneath the joint cell, in every rank alike
(rank 0 is the test's process; each helper rank calls ``apply`` first
thing): the cell's judge must come out not correct."""

import functools

KINDS = ("lm_capped", "pose_moved", "points_pushed", "rank_perturbed")


def patched(kind, rank, real):
    """``sharded_lm_solve`` (``real``) broken by ``kind`` on ``rank``,
    with ``real``'s signature."""
    @functools.wraps(real)
    def solve(problem, group=None, **k):
        if kind == "lm_capped":
            k["max_iters"] = 1
        v, hist = real(problem, group, **k)
        if kind == "pose_moved":
            t = v.pose_t.clone()
            t[len(t) // 2, 0] += 1e-3
            v = v._replace(pose_t=t)
        elif kind == "points_pushed":
            # every tenth landmark 100 times as far from the first camera
            X = v.points.clone()
            c0 = v.pose_t[0]
            X[::10] = c0 + 100.0 * (X[::10] - c0)
            v = v._replace(points=X)
        elif kind == "rank_perturbed" and rank == 1:
            X = v.points.clone()
            X[0, 0] += 1e-6
            v = v._replace(points=X)
        return v, hist
    return solve


def apply(kind, rank):
    """Break this process's ``sharded_lm_solve`` by ``kind``."""
    from mqslam_tpu_torch.parallel import sharded_ba
    sharded_ba.sharded_lm_solve = patched(kind, rank,
                                          sharded_ba.sharded_lm_solve)
