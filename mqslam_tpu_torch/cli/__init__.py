"""Headless command-line entry points.

  python -m mqslam_tpu_torch.cli.slam_run      — SLAM front-end over an
                                                 image directory: TUM
                                                 trajectory, PCD map and
                                                 (optionally) a BA_info dump
  python -m mqslam_tpu_torch.cli.ba_run        — bundle adjustment over a
                                                 BA_info dump (mode 0)
  python -m mqslam_tpu_torch.cli.evaluate_ate  — absolute trajectory error
  python -m mqslam_tpu_torch.cli.evaluate_rpe  — relative pose error
  python -m mqslam_tpu_torch.cli.align_traj    — anchored scale alignment of
                                                 trajectories and maps
  python -m mqslam_tpu_torch.cli.calibrate     — camera calibration from
                                                 chessboard images
                                                 (intrinsics, undistort,
                                                 pose, relative, two-view)
"""
