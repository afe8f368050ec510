"""Relative pose error CLI (TUM benchmark tool surface).

Reference: Work/SLAM/tools/tum_benchmark_tools/evaluate_rpe.py:299-388
(incl. the --plot/--save outputs, :321-386).

    python -m mqslam_tpu_torch.cli.evaluate_rpe GT_FILE EST_FILE \\
        [--fixed_delta] [--verbose]

NumPy float64 on the host, the JAX package's CLI with the same arguments
and output files; ``--plot`` needs matplotlib and says so where it does not
import.
"""

import argparse

from mqslam_tpu_torch.cli.evaluate_ate import _need_matplotlib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth_file")
    ap.add_argument("estimated_file")
    ap.add_argument("--fixed_delta", action="store_true")
    ap.add_argument("--delta", type=float, default=1.0)
    ap.add_argument("--delta_unit", default="s", choices=["s", "f"])
    ap.add_argument("--max_pairs", type=int, default=10000)
    ap.add_argument("--save", help="save per-pair evaluation (stamp_est0 "
                    "stamp_est1 stamp_gt0 stamp_gt1 trans_err rot_err)")
    ap.add_argument("--plot", help="plot errors over time to a file "
                    "(requires --fixed_delta; format by extension)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.plot and not args.fixed_delta:
        ap.error("--plot requires --fixed_delta")
    if args.plot:
        _need_matplotlib(ap)

    from mqslam_tpu_torch.eval import rpe
    from mqslam_tpu_torch.io import tum

    gt = tum.load_trajectory(args.groundtruth_file)
    est = tum.load_trajectory(args.estimated_file)
    res = rpe.evaluate_rpe(est, gt, fixed_delta=args.fixed_delta,
                           delta=args.delta, delta_unit=args.delta_unit,
                           max_pairs=args.max_pairs)
    if args.verbose:
        print(f"compared_pose_pairs {res.n_pairs} pairs")
        print(f"translational_error.rmse {res.trans_rmse:.6f} m")
        print(f"translational_error.mean {res.trans_mean:.6f} m")
        print(f"translational_error.median {res.trans_median:.6f} m")
        import math
        print(f"rotational_error.rmse "
              f"{res.rot_rmse * 180.0 / math.pi:.6f} deg")
        print(f"rotational_error.mean "
              f"{res.rot_mean * 180.0 / math.pi:.6f} deg")
    else:
        print(f"{res.trans_rmse:.6f}")

    if args.save:
        with open(args.save, "w") as f:
            for stamps, t_e, r_e in zip(res.pair_stamps, res.trans_errors,
                                        res.rot_errors):
                # %f fixed-point, matching the reference (evaluate_rpe.py:347)
                f.write(" ".join(f"{s:f}" for s in stamps)
                        + f" {t_e:f} {r_e:f}\n")
    if args.plot:
        import math

        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        stamps = res.pair_stamps[:, 0] - res.pair_stamps[0, 0]
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
        ax1.plot(stamps, res.trans_errors, "-", color="blue")
        ax1.set_ylabel("translational error [m]")
        ax2.plot(stamps, res.rot_errors * 180.0 / math.pi, "-",
                 color="red")
        ax2.set_ylabel("rotational error [deg]")
        ax2.set_xlabel("time [s]")
        plt.savefig(args.plot, dpi=300)
        plt.close(fig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
