#!/usr/bin/env python3
"""The JAX package's own results on the two BA-at-scale workloads that
``chip_smoke.py``'s ``ba_scale`` phase holds the port to.

    JAX_PLATFORMS=cpu python3 ref_ba_scale_jax.py

1. ``lm_solve(method="cg", layout="auto", max_iters=20, cg_iters=300,
   lam0=1e-4)`` on the corridor problem at the JAX bench's production size
   (2048 poses, 24 landmarks a frame): the final cost against the cost at
   the truth, and the mean camera-centre error against the initial one;
   then 20 more LM iterations at 1000 CG iterations from there
   (``longer``), which show how flat the valley around the optimum is.
   LM starts at lam0 = 1e-4: below it the corridor's first damped system
   is indefinite in float32, truncated CG returns a meaningless step, and
   whether LM accepts it is roundoff (on the card, where sums are atomic,
   the run then differs from run to run).
2. ``incremental_solve`` (what ``ba_run`` modes 1 and 2 run) over the whole
   schedule of ``artifacts/icl_r5b`` (200 poses, 798 landmarks): the
   largest and the mean distance of its camera centres to the checked-in
   mode-0 output (``traj_out.cam0-mqslam-BA.txt``).

Prints one JSON line with both, the backend and the seconds of each
(a few minutes on a CPU).
"""

import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ICL = os.path.join(ROOT, "artifacts", "icl_r5b")


def corridor():
    from mqslam_tpu.ba import solver, synthetic
    prob, v_true = synthetic.generate_corridor_problem(nr_frames=2048,
                                                       points_per_frame=24)
    t0 = time.perf_counter()
    v, hist = solver.lm_solve(prob, method="cg", layout="auto", max_iters=20,
                              cg_iters=300, lam0=1e-4)
    seconds = time.perf_counter() - t0
    err = lambda p: float(np.linalg.norm(
        np.asarray(p) - np.asarray(v_true.pose_t), axis=1).mean())
    v2, hist2 = solver.lm_solve(prob, v, method="cg", layout="auto",
                                max_iters=20, cg_iters=1000)
    return dict(iterations=len(hist) - 1, history_ends=[hist[0], hist[-1]],
                cost_at_truth=float(solver.compute_cost(prob, v_true)),
                pose_err_mean_m=err(v.pose_t),
                pose_err0_mean_m=err(prob.init.pose_t), seconds=seconds,
                longer=dict(iterations=len(hist2) - 1, final_cost=hist2[-1],
                            pose_err_mean_m=err(v2.pose_t)))


def incremental_icl():
    from mqslam_tpu.ba import incremental, problem
    from mqslam_tpu.io import ba_info, tum
    data = ba_info.load_ba_data(ICL, "mqslam", 1, 30)
    prob = problem.problem_from_ba_data(data)
    t0 = time.perf_counter()
    v, hist = incremental.incremental_solve(data, prob)
    seconds = time.perf_counter() - t0
    ref = tum.load_trajectory(os.path.join(ICL,
                                           "traj_out.cam0-mqslam-BA.txt"))
    centres = np.asarray(v.pose_t)[np.asarray(prob.pose_valid)]
    d = np.linalg.norm(centres - ref.locations, axis=1)
    return dict(steps=len(hist), history_ends=[hist[0], hist[-1]],
                centre_max_m=float(d.max()), centre_mean_m=float(d.mean()),
                seconds=seconds)


def main():
    import jax
    print(json.dumps(dict(backend=jax.default_backend(),
                          corridor=corridor(),
                          incremental_icl=incremental_icl())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
