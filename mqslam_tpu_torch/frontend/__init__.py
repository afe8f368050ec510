"""Keyframe visual-odometry front-end: a fixed-capacity track-table state
machine, one step per frame (or per frame-group of A agents)."""

from mqslam_tpu_torch.frontend.tracker import (  # noqa: F401
    TrackerConfig, TrackerState, StepOutput, make_step, bootstrap,
    make_scan_runner, make_multi_agent_runner,
)
