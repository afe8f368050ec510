"""Small shared utilities: timers, spans, traces."""

from mqslam_tpu_torch.utils.profiling import Timer  # noqa: F401
