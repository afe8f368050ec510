"""Headless command-line entry points.

  python -m mqslam_tpu_torch.cli.slam_run  — SLAM front-end over an image
                                             directory: TUM trajectory, PCD
                                             map and (optionally) a BA_info
                                             dump
"""
