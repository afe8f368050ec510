"""Camera-calibration CLI — the reference's interactive menu, headless.

Subcommand surface of the reference's option menu (reference:
Work/calibration/application/calibrate.py:673-820: grid_objp :720,
calibrate_camera_interactive :726, save/load :740-752, undistort_image
:754, triangl_pose_est :774, realtime_pose_estimation :788,
calibrate_relative_poses_interactive :799), driven by arguments instead of
prompts:

  calibrate intrinsics <img_dir> <COLSxROWS> -o camera_intrinsics.txt
  calibrate undistort  <intrinsics> <image> -o undistorted.png
  calibrate pose       <img_dir> <COLSxROWS> <intrinsics> [-o snap_dir]
  calibrate relative   <intrinsics> <COLSxROWS> <cam0_dir> <cam1_dir> ...
  calibrate two-view   <intrinsics> <COLSxROWS> <imgA> <imgB>

Every subcommand takes ``--device`` (default: the CUDA device; ``cpu``
runs on the CPU).
"""

import argparse
import os
import sys

import numpy as np


def _board(arg):
    cols, rows = (int(v) for v in arg.lower().split("x"))
    return cols, rows


def _load_gray_dir(img_dir):
    from mqslam_tpu_torch.io import images
    paths = images.image_filepaths_by_directory(img_dir)
    return [images.load_image_gray(p) for p in paths], paths


def _cal(K, dist, device):
    from mqslam_tpu_torch import convert
    return convert.cal_from_K_dist(K, dist[:4], device=device)


def cmd_intrinsics(args, device):
    from mqslam_tpu_torch.calib import zhang
    from mqslam_tpu_torch.io import intrinsics as iio

    imgs, paths = _load_gray_dir(args.img_dir)
    if not imgs:
        print(f"no images in {args.img_dir}", file=sys.stderr)
        return 1
    K, dist, rvecs, tvecs, rms, used = zhang.calibrate_camera_from_images(
        imgs, _board(args.board), square_size=args.square_size,
        device=device)
    h, w = np.asarray(imgs[0]).shape
    print(f"used {used.sum()}/{len(imgs)} images; reprojection RMS "
          f"{rms:.4f} px")
    print("cameraMatrix:\n", np.round(K, 4))
    print("distCoeffs:", np.round(dist, 6))
    dist5 = np.concatenate([dist, [0.0]])  # reference files carry 5 coeffs
    iio.save_camera_intrinsics(args.out, K, dist5, (w, h))
    print(f"wrote {args.out}")
    return 0


def cmd_undistort(args, device):
    from mqslam_tpu_torch.calib import undistort as ud
    from mqslam_tpu_torch.io import images, intrinsics as iio
    from mqslam_tpu_torch.viz.painter import save_png

    K, dist, size = iio.load_camera_intrinsics(args.intrinsics)
    img = images.load_image_gray(args.image)
    out, roi = ud.undistort_image(np.asarray(img), _cal(K, dist, device),
                                  alpha=args.alpha, device=device)
    save_png(args.out, np.clip(out, 0, 255).astype(np.uint8))
    print(f"wrote {args.out} (ROI x={roi[0]} y={roi[1]} w={roi[2]} "
          f"h={roi[3]})")
    return 0


def cmd_pose(args, device):
    from mqslam_tpu_torch.calib import realtime as rt
    from mqslam_tpu_torch.io import intrinsics as iio

    K, dist, _ = iio.load_camera_intrinsics(args.intrinsics)
    imgs, paths = _load_gray_dir(args.img_dir)
    n_found = 0
    for i, (img, p) in enumerate(zip(imgs, paths)):
        ok, rvec, tvec, overlay = rt.pose_from_chessboard_frame(
            np.asarray(img), _board(args.board), K, dist[:4],
            square_size=args.square_size, overlay=args.out is not None,
            device=device)
        if not ok:
            print(f"{os.path.basename(p)}: chessboard not found")
            continue
        n_found += 1
        print(f"{os.path.basename(p)}: rvec={np.round(rvec, 4)} "
              f"tvec={np.round(tvec, 4)}")
        if args.out:
            rt.save_pose_snapshot(args.out, i, overlay, rvec, tvec)
    print(f"pose estimated in {n_found}/{len(imgs)} frames")
    return 0 if n_found else 1


def cmd_relative(args, device):
    from mqslam_tpu_torch.calib import relative as rel
    from mqslam_tpu_torch.calib.zhang import grid_objp
    from mqslam_tpu_torch.io import intrinsics as iio
    from mqslam_tpu_torch.ops import chessboard as cb

    K, dist, _ = iio.load_camera_intrinsics(args.intrinsics)
    board = _board(args.board)
    per_cam = []
    for d in args.cam_dirs:
        imgs, _ = _load_gray_dir(d)
        pts = []
        for img in imgs:
            ok, c = cb.find_chessboard_corners(np.asarray(img), board,
                                               device=device)
            pts.append(c if ok else None)
        per_cam.append(pts)
    # keep images where every camera found its board
    n_img = min(len(p) for p in per_cam)
    keep = [i for i in range(n_img)
            if all(p[i] is not None for p in per_cam)]
    if not keep:
        print("no image index where all cameras see their board",
              file=sys.stderr)
        return 1
    per_cam = [[p[i] for i in keep] for p in per_cam]
    objp = grid_objp(board, scale=args.square_size)
    cal = _cal(K, dist, device)
    n_cams = len(per_cam)
    poses, worst = rel.calibrate_relative_poses(
        per_cam, [objp] * n_cams, [cal] * n_cams, device=device)
    for c, P in enumerate(poses):
        print(f"cam{c} relative to cam0 (4x4):\n", np.round(P, 6))
    print(f"worst reprojection error: {worst:.4f} px "
          f"({len(keep)} joint images)")
    return 0


def cmd_two_view(args, device):
    import torch
    from mqslam_tpu_torch.calib import epipolar as ep
    from mqslam_tpu_torch.core import camera as cam_mod, se3
    from mqslam_tpu_torch.io import images, intrinsics as iio
    from mqslam_tpu_torch.ops import chessboard as cb, triangulation as tri

    K, dist, _ = iio.load_camera_intrinsics(args.intrinsics)
    board = _board(args.board)
    okA, cA = cb.find_chessboard_corners(
        np.asarray(images.load_image_gray(args.imgA)), board, device=device)
    okB, cB = cb.find_chessboard_corners(
        np.asarray(images.load_image_gray(args.imgB)), board, device=device)
    if not (okA and okB):
        print("chessboard not found in both images", file=sys.stderr)
        return 1
    cal = _cal(K, dist, device)
    nA = cam_mod.undistort_points(torch.as_tensor(cA).to(device), cal)
    nB = cam_mod.undistort_points(torch.as_tensor(cB).to(device), cal)
    # E = F on normalized coordinates (calibrate.py:293)
    E = ep.fundamental_8point(nA, nB)
    R, t, n_front = ep.relative_pose_from_fundamental(E, nA, nB)
    print("relative pose R:\n", np.round(R.cpu().numpy(), 6))
    print("t (unit scale):", np.round(t.cpu().numpy(), 6),
          f"({int(n_front)}/{len(cA)} points in front)")
    P1 = torch.eye(4, device=device)
    P2 = se3.from_R_t(R, t)
    pts, status = tri.iterative_ls(nA, P1, nB, P2)
    print(f"triangulated {int((status == 1).sum())}/{len(cA)} "
          f"chessboard corners")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="calibrate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device to run on (default: the CUDA device; "
                   "'cpu' runs on the CPU)")

    p = sub.add_parser("intrinsics", help="calibrate from chessboard images")
    p.add_argument("img_dir")
    p.add_argument("board", help="inner corners, e.g. 8x6")
    p.add_argument("-o", "--out", default="camera_intrinsics.txt")
    p.add_argument("--square-size", type=float, default=1.0)
    p.set_defaults(fn=cmd_intrinsics)

    p = sub.add_parser("undistort", help="undistort one image")
    p.add_argument("intrinsics")
    p.add_argument("image")
    p.add_argument("-o", "--out", default="undistorted.png")
    p.add_argument("--alpha", type=float, default=1.0)
    p.set_defaults(fn=cmd_undistort)

    p = sub.add_parser("pose", help="chessboard pose per frame")
    p.add_argument("img_dir")
    p.add_argument("board")
    p.add_argument("intrinsics")
    p.add_argument("-o", "--out", default=None,
                   help="snapshot dir (axis-overlay PNG + pose txt)")
    p.add_argument("--square-size", type=float, default=1.0)
    p.set_defaults(fn=cmd_pose)

    p = sub.add_parser("relative", help="multi-camera relative poses")
    p.add_argument("intrinsics")
    p.add_argument("board")
    p.add_argument("cam_dirs", nargs="+")
    p.add_argument("--square-size", type=float, default=1.0)
    p.set_defaults(fn=cmd_relative)

    p = sub.add_parser("two-view", help="two-view pose + triangulation lab")
    p.add_argument("intrinsics")
    p.add_argument("board")
    p.add_argument("imgA")
    p.add_argument("imgB")
    p.set_defaults(fn=cmd_two_view)

    for p in sub.choices.values():
        p.add_argument("--device", default=None, help=device_help)
    args = ap.parse_args(argv)

    from mqslam_tpu_torch import resolve_device
    return args.fn(args, resolve_device(args.device))


if __name__ == "__main__":
    raise SystemExit(main())
