"""Geometry core: quaternions, SO(3), SE(3), cameras, distortion.

Everything here broadcasts over leading batch dimensions and has no
data-dependent Python control flow.
"""

from mqslam_tpu_torch.core import quat, so3, se3, camera  # noqa: F401
