"""Headless SLAM front-end runner: image directory -> TUM trajectory + PCD map
(+ optional BA_info dump).

CLI role of the reference's slam2 main (reference: Work/SLAM/application/own/
slam2.py:868-1018 argument surface, :1021-1253 main loop) and of the headless
SVO runner (Work/SLAM/application/SVO/run_pipeline.cpp:266-309).

    python -m mqslam_tpu_torch.cli.slam_run IMG_DIR camera_intrinsics.txt \\
        --init-pose init_pose.txt --init-points init_points.pcd \\
        --ba-info-dir OUT [--loop-closure] [--checkpoint ck.npz
        [--checkpoint-every N] [--resume]] [--device cuda|cpu]

or ``--init-chessboard COLSxROWS [--square-size S]`` in place of the two
``--init-*`` files (the board's inner corners in frame 0 bootstrap the map),
and ``--debug-dir D [--debug-every N]`` for the Composite 2D/3D PNG views.

The RANSAC draws come from a generator seeded 0 on the device, so a run
resumed with ``--resume`` repeats the uninterrupted one.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("img_dir", help="directory with the image sequence")
    ap.add_argument("cam_intrinsics_file",
                    help="camera_intrinsics.txt (reference wire format)")
    ap.add_argument("--init-pose", dest="init_pose", default=None,
                    help="init_pose.txt: 4x4 extrinsic matrix (the "
                         "reference's np.loadtxt format, slam2.py:1054) or "
                         "a TUM line with the first pose")
    ap.add_argument("--init-points", dest="init_points", default=None,
                    help="init_points.pcd with known 3D points visible in "
                         "frame 0")
    ap.add_argument("--traj-out", default="traj_out.cam0-mqslam.txt")
    ap.add_argument("--map-out", default="map_out-mqslam.pcd")
    ap.add_argument("--ba-info-dir", default=None,
                    help="directory to write the BA_info.* dump into")
    ap.add_argument("--ba-name", default="mqslam")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--max-tracks", type=int, default=384)
    ap.add_argument("--target-keypoints", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device; "
                         "'cpu' runs on the CPU)")
    ap.add_argument("--init-chessboard", default=None, metavar="COLSxROWS",
                    help="bootstrap from a chessboard visible in frame 0 "
                         "(e.g. 8x6 inner corners), instead of "
                         "--init-pose/--init-points (slam2.py:1121-1129)")
    ap.add_argument("--square-size", type=float, default=1.0,
                    help="chessboard square size in world units")
    ap.add_argument("--loop-closure", action="store_true",
                    help="ORB loop-closure + pose-graph correction")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file (written every "
                         "--checkpoint-every frames)")
    ap.add_argument("--checkpoint-every", type=int, default=30)
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint")
    ap.add_argument("--debug-dir", default=None,
                    help="write Composite 2D/3D debug views (PNG) here — "
                         "the headless equivalent of slam2's __debug__ "
                         "windows (slam2.py:1227-1242)")
    ap.add_argument("--debug-every", type=int, default=10,
                    help="debug-view period in frames (keyframes and "
                         "rejected frames always draw)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from mqslam_tpu_torch import convert, resolve_device
    from mqslam_tpu_torch.core import camera as cam_mod
    from mqslam_tpu_torch.frontend import tracker as trk
    from mqslam_tpu_torch.frontend.runner import run_frontend
    from mqslam_tpu_torch.io import images, intrinsics, pcd, tum, ba_info

    device = resolve_device(args.device)
    K, dist, size = intrinsics.load_camera_intrinsics(
        args.cam_intrinsics_file)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    cal = convert.cal_from_K_dist(K, dist, device=device)
    paths = images.image_filepaths_by_directory(args.img_dir)
    if args.max_frames:
        paths = paths[:args.max_frames]
    if not paths:
        print(f"No images found in {args.img_dir}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"{len(paths)} frames; intrinsics fx={K[0,0]:.2f} "
              f"fy={K[1,1]:.2f}; device {device}")

    if args.init_chessboard:
        # chessboard bootstrap: inner corners of the board in frame 0 are
        # the initial 2D-3D correspondences (slam2.py:1121-1146)
        from mqslam_tpu_torch.calib.zhang import grid_objp
        from mqslam_tpu_torch.ops import chessboard as cb

        cols, rows = (int(v) for v in args.init_chessboard.lower()
                      .split("x"))
        frame0 = images.load_image_gray(paths[0])
        found, uv0 = cb.find_chessboard_corners(frame0, (cols, rows),
                                                device=device)
        if not found:
            print("First image must contain the entire chessboard! "
                  "(slam2.py:1122-1124)", file=sys.stderr)
            return 1
        pts3d = grid_objp((cols, rows),
                          scale=args.square_size).astype(np.float32)
        if not args.quiet:
            print(f"init: {len(uv0)} chessboard corners detected")
    elif args.init_pose and args.init_points:
        # init pose + init 3D points; project to get frame-0 2D points.
        # init_pose.txt is either a plain 4x4 world->cam extrinsic matrix
        # (slam2.py:1054-1060 loads it with np.loadtxt) or a TUM line.
        raw = np.loadtxt(args.init_pose)
        if raw.shape == (4, 4):
            P0 = raw
        else:
            init = tum.load_trajectory(args.init_pose)
            P0 = tum.extrinsics_from_trajectory(init)[0]
        pts3d, _, _ = pcd.load_pcd(args.init_points)
        uv0, depth = cam_mod.project(f32(pts3d), f32(P0), cal)
        uv0, depth = uv0.cpu().numpy(), depth.cpu().numpy()
        # visibility filter: in front of the camera AND inside the image
        # (transforms.py:200-226 project_points status; slam2.py:1058-1060)
        w, h = int(size[0]), int(size[1])
        ok = ((depth > 0)
              & (uv0[:, 0] >= 0) & (uv0[:, 0] < w)
              & (uv0[:, 1] >= 0) & (uv0[:, 1] < h))
        uv0 = uv0[ok]
        pts3d = pts3d[ok]
        if not args.quiet:
            print(f"init: {ok.sum()}/{len(ok)} predefined points visible "
                  f"in frame 0")
    else:
        print("Provide --init-chessboard COLSxROWS (chessboard bootstrap) "
              "or --init-pose/--init-points (predefined-points bootstrap, "
              "svo_initialization.py).", file=sys.stderr)
        return 1

    config = trk.TrackerConfig(max_tracks=args.max_tracks,
                               target_keypoints=args.target_keypoints)
    res = run_frontend((images.load_image_gray(p) for p in paths),
                       cal, config, uv0.astype(np.float32),
                       pts3d.astype(np.float32), fps=args.fps,
                       generator=torch.Generator(device=device).manual_seed(0),
                       collect_ba=args.ba_info_dir is not None,
                       verbose=not args.quiet, t0=1.0 / args.fps,
                       loop_closure=args.loop_closure,
                       checkpoint_every=(args.checkpoint_every
                                         if args.checkpoint else 0),
                       checkpoint_path=args.checkpoint,
                       resume_from=(args.checkpoint if args.resume
                                    else None),
                       debug_dir=args.debug_dir,
                       debug_every=args.debug_every, device=device)

    tum.save_trajectory(args.traj_out, res.trajectory)
    gray = np.clip(res.point_colors, 0, 255).astype(np.uint8)
    colors = np.stack([gray, gray, gray], axis=1)
    pcd.save_pcd(args.map_out, res.points3d, colors)
    if args.ba_info_dir:
        ba_info.save_ba_data(args.ba_info_dir, args.ba_name, res.ba_data)
    n_acc = sum(1 for a in res.accepted if a > 0)
    print(f"done: {n_acc}/{len(res.accepted)} frames accepted, "
          f"{res.n_keyframes} keyframes, {len(res.points3d)} landmarks -> "
          f"{args.traj_out}, {args.map_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
