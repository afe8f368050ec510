"""Absolute trajectory error CLI (TUM benchmark tool surface).

Reference: Work/SLAM/tools/tum_benchmark_tools/evaluate_ate.py:115-197
(incl. the --plot/--save/--save_associations outputs, :125-197).

    python -m mqslam_tpu_torch.cli.evaluate_ate GT_FILE EST_FILE [--verbose]

NumPy float64 on the host, the JAX package's CLI with the same arguments
and output files; ``--plot`` needs matplotlib and says so where it does not
import.
"""

import argparse


def _plot_traj(ax, stamps, xyz, style, color, label, gap=0.01):
    """Plot x-y track segments, breaking the line where timestamps jump
    (evaluate_ate.py:83-112)."""
    import numpy as np
    stamps = np.asarray(stamps, dtype=np.float64)
    order = np.argsort(stamps)
    stamps, xyz = stamps[order], np.asarray(xyz)[order]
    interval = np.median(np.diff(stamps)) if len(stamps) > 1 else gap
    breaks = np.flatnonzero(np.diff(stamps) > 2 * interval)
    start = 0
    shown = False
    for b in list(breaks) + [len(stamps) - 1]:
        seg = slice(start, b + 1)
        if seg.stop - seg.start > 0:
            ax.plot(xyz[seg, 0], xyz[seg, 1], style, color=color,
                    label=None if shown else label)
            shown = True
        start = b + 1


def _need_matplotlib(ap):
    """--plot fails with a message, not a traceback, without matplotlib."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        ap.error("--plot needs matplotlib, which does not import here")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("first_file", help="ground-truth trajectory (TUM)")
    ap.add_argument("second_file", help="estimated trajectory (TUM)")
    ap.add_argument("--offset", type=float, default=0.0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--max_difference", type=float, default=0.02)
    ap.add_argument("--save", help="save aligned second trajectory "
                    "(stamp x y z per line)")
    ap.add_argument("--save_associations", help="save associated pairs "
                    "(stamp1 x1 y1 z1 stamp2 x2 y2 z2 per line)")
    ap.add_argument("--plot", help="plot ground truth + aligned estimate "
                    "to an image (format by extension: png/pdf)")
    ap.add_argument("--plot_original", action="store_true",
                    help="plot the original (unaligned) estimate")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.plot:
        _need_matplotlib(ap)

    import numpy as np

    from mqslam_tpu_torch.eval import ate
    from mqslam_tpu_torch.io import tum

    gt = tum.load_trajectory(args.first_file)
    est = tum.load_trajectory(args.second_file)
    res = ate.evaluate_ate(est, gt, max_difference=args.max_difference,
                           offset=-args.offset, scale=args.scale)
    if args.verbose:
        print(f"compared_pose_pairs {res.n_pairs} pairs")
        print(f"absolute_translational_error.rmse {res.rmse:.6f} m")
        print(f"absolute_translational_error.mean {res.mean:.6f} m")
        print(f"absolute_translational_error.median {res.median:.6f} m")
        print(f"absolute_translational_error.std {res.std:.6f} m")
        print(f"absolute_translational_error.min {res.min:.6f} m")
        print(f"absolute_translational_error.max {res.max:.6f} m")
    else:
        print(f"{res.rmse:.6f}")

    if args.save or args.save_associations or args.plot:
        est_xyz = np.asarray(est.locations, dtype=np.float64) * args.scale
        est_aligned = est_xyz @ res.rotation.T + res.translation
        gt_xyz = np.asarray(gt.locations, dtype=np.float64)
        i1, i2 = res.matches[:, 0], res.matches[:, 1]

    # fixed-point %f formatting matches the reference tool's output format
    # (evaluate_ate.py:167-172) — repr-style f"{v}" may emit scientific
    # notation (1e-05) that TUM-format consumers misparse
    if args.save:
        with open(args.save, "w") as f:
            for ts, p in zip(est.timestamps, est_aligned):
                f.write(f"{ts:f} " + " ".join(f"{v:f}" for v in p) + "\n")
    if args.save_associations:
        with open(args.save_associations, "w") as f:
            for a, b in zip(i2, i1):
                f.write(f"{gt.timestamps[a]:f} "
                        + " ".join(f"{v:f}" for v in gt_xyz[a])
                        + f" {est.timestamps[b]:f} "
                        + " ".join(f"{v:f}" for v in est_aligned[b]) + "\n")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        _plot_traj(ax, gt.timestamps, gt_xyz, "-", "black", "ground truth")
        est_plot = est_xyz if args.plot_original else est_aligned
        _plot_traj(ax, est.timestamps, est_plot, "-", "blue", "estimated")
        seg_label = "difference"
        for a, b in zip(i2, i1):
            ax.plot([gt_xyz[a, 0], est_plot[b, 0]],
                    [gt_xyz[a, 1], est_plot[b, 1]], "-", color="red",
                    alpha=0.5, label=seg_label)
            seg_label = ""
        ax.legend()
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_aspect("equal", adjustable="datalim")
        plt.savefig(args.plot, dpi=90)
        plt.close(fig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
