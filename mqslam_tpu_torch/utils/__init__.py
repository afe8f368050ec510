"""Small shared utilities: timers, traces."""

from mqslam_tpu_torch.utils.profiling import Timer, timers  # noqa: F401
