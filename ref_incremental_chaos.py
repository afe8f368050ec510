#!/usr/bin/env python3
"""How far roundoff alone moves the port's incremental BA schedule, on a
CPU: the reason ``chip_smoke.py`` compares the card with the CPU in
lockstep (``incremental_lockstep``) and not as two free runs.

    python3 ref_incremental_chaos.py [--runs 16] [--steps 30] [--eps 1e-6]

The first ``--steps`` steps of ``artifacts/icl_r5b`` (200 poses, 798
landmarks; the dense path) run once from the dump's values, then ``--runs``
times from initial camera translations scaled by ``1 + eps * N(0, 1)``
(seed 0), a few float32 ulps.  Each perturbed copy runs free, as
``incremental_solve``, and in lockstep with the unperturbed one, following
its accept decisions.  For each it prints the largest relative difference
of the per-step costs from step 1 on (step 0's cost, 3.5e-9, is the
roundoff of one keyframe's exact fit, which the perturbation itself moves)
and the largest distance between final camera centres, free and in
lockstep, one JSON line a run and a summary line of the largest values.
One torch thread, about 1.5 minutes a run.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from mqslam_tpu_torch.ba import incremental as binc, problem as bp
from mqslam_tpu_torch.io import ba_info

ICL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                   "icl_r5b")


def apart(h, v, h0, v0):
    """(largest relative per-step cost difference from step 1 on, largest
    final camera-centre distance in m)."""
    r = np.abs(np.array(h[1:]) / np.array(h0[1:]) - 1)
    return float(r.max()), float((v.pose_t - v0.pose_t).norm(dim=1).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--eps", type=float, default=1e-6)
    args = ap.parse_args()
    torch.set_num_threads(1)
    data = ba_info.load_ba_data(ICL, "mqslam", nr_cameras=1, fps=30)
    p = bp.problem_from_ba_data(data, device="cpu")
    v0, h0 = binc.incremental_solve(data, p, max_steps=args.steps)
    rng = np.random.default_rng(0)
    rows = []
    for k in range(args.runs):
        t0 = time.perf_counter()
        eps = torch.as_tensor(rng.standard_normal(p.init.pose_t.shape)
                              * args.eps, dtype=torch.float32)
        q = p._replace(init=p.init._replace(pose_t=p.init.pose_t
                                            * (1 + eps)))
        v, h = binc.incremental_solve(data, q, max_steps=args.steps)
        (_, vl), (_, hl) = binc.incremental_lockstep(
            data, [p, q], max_steps=args.steps)
        free, lock = apart(h, v, h0, v0), apart(hl, vl, h0, v0)
        rows.append(dict(run=k, free_cost_rel=free[0], free_centre_m=free[1],
                         lockstep_cost_rel=lock[0],
                         lockstep_centre_m=lock[1],
                         seconds=time.perf_counter() - t0))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({k: max(r[k] for r in rows) for k in rows[0]
                      if k != "run"} | dict(runs=args.runs, eps=args.eps,
                                            steps=args.steps)))


if __name__ == "__main__":
    main()
