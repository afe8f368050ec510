"""Camera calibration math (the reference's interactive suite, as a library).

The reference wraps this in OpenCV-GUI menus (reference: Work/calibration/
application/calibrate.py); the math lives here as tested functions:
Zhang-style intrinsics calibration from chessboard views, multi-camera
relative-pose calibration with reprojection-error weighting, image
undistortion, and the two-view epipolar toolbox (normalized 8-point F,
RANSAC with its draws as an argument, essential-matrix decomposition with
chirality disambiguation).
"""

from mqslam_tpu_torch.calib import zhang, relative, epipolar  # noqa: F401
from mqslam_tpu_torch.calib.zhang import calibrate_camera  # noqa: F401
from mqslam_tpu_torch.calib.relative import (  # noqa: F401
    calibrate_relative_poses,
)
from mqslam_tpu_torch.calib.epipolar import (  # noqa: F401
    fundamental_8point, fundamental_ransac, decompose_essential,
    relative_pose_from_fundamental,
)
