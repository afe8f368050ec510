"""Align trajectories + maps to ground truth (monocular scale correction).

CLI role of the reference's align_traj_and_map_to_groundtruth.py:13-95:
computes the anchored (quaternion, scale, translation) transform from the
estimated trajectory to the ground truth and applies it to trajectories
and PCD maps, writing "-trfm" outputs.

    python -m mqslam_tpu_torch.cli.align_traj GT_TRAJ EST_TRAJ \\
        [--maps MAP.pcd ...] [--device cuda|cpu]

The quaternion algebra runs in float32 on ``--device`` (default: the CUDA
device).
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth_traj")
    ap.add_argument("estimated_traj")
    ap.add_argument("--maps", nargs="*", default=[],
                    help="PCD maps to transform along")
    ap.add_argument("--at-frame", type=int, default=1)
    ap.add_argument("--no-scale", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the quaternion algebra (default: "
                         "the CUDA device; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from mqslam_tpu_torch.eval import alignment
    from mqslam_tpu_torch.io import pcd, tum

    gt = tum.load_trajectory(args.groundtruth_traj)
    est = tum.load_trajectory(args.estimated_traj)
    trfm = alignment.transform_between_trajectories(
        est, gt, at_frame=args.at_frame, infer_scale=not args.no_scale,
        device=args.device)
    print(f"delta_quaternion={trfm[0]} scale={trfm[1]:.6f} "
          f"delta_location={trfm[2]}")

    out_traj = _suffix(args.estimated_traj, "-trfm")
    tum.save_trajectory(out_traj, alignment.transform_trajectory(
        est, trfm, device=args.device))
    print(f"wrote {out_traj}")
    for m in args.maps:
        pts, colors, _ = pcd.load_pcd(m, use_alpha=True)
        pts2 = alignment.transform_points(pts, trfm, device=args.device)
        out_map = _suffix(m, "-trfm")
        pcd.save_pcd(out_map, pts2, colors)
        print(f"wrote {out_map}")
    return 0


def _suffix(path, suffix):
    base, ext = os.path.splitext(path)
    return base + suffix + ext


if __name__ == "__main__":
    raise SystemExit(main())
