#!/usr/bin/env python3
"""The corridor LM of ``chip_smoke.py``'s ``ba_scale`` phase, repeated, at
two starting dampings, on the card.

    python3 ref_corridor_lm_lam0.py [RUNS]

Runs ``lm_solve(method="cg", layout="auto", max_iters=20, cg_iters=300)``
on the corridor problem at 2048 poses / 24 landmarks a frame RUNS times
(default 8) from lam0 = 1e-6 and RUNS times from lam0 = 1e-4, and prints
one line a run: seconds, LM iterations, the final cost over the cost at
the truth, the mean camera-centre error.  At 1e-6 the first damped system
is indefinite in float32, whether LM accepts CG's step is roundoff, and
the card's atomic sums make runs differ; at 1e-4 they agree.  Needs a
CUDA device.
"""

import sys
import time

import torch

from mqslam_tpu_torch.ba import solver as bs, synthetic as bsyn


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else 8
    dev = torch.device("cuda")
    prob, v_true = bsyn.generate_corridor_problem(2048, 24, device=dev)
    c_true = float(bs.compute_cost(prob, v_true))
    err = lambda v: (v.pose_t - v_true.pose_t).norm(dim=1).mean().item()
    print(f"{torch.cuda.get_device_name(0)}; initial error "
          f"{err(prob.init):.5f} m", flush=True)
    for lam0 in (1e-6, 1e-4):
        for run in range(runs):
            t0 = time.perf_counter()
            v, hist = bs.lm_solve(prob, method="cg", layout="auto",
                                  max_iters=20, cg_iters=300, lam0=lam0)
            print(f"lam0 {lam0:g} run {run}: "
                  f"{time.perf_counter() - t0:.1f} s, {len(hist) - 1} "
                  f"iterations, final / truth {hist[-1] / c_true:.4f}, "
                  f"error {err(v):.5f} m", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
