"""Host-side IO: TUM trajectories, ASCII PCD point clouds, camera intrinsics,
image sequences and the BA_info factor-graph wire format.

All of this is NumPy code with no tensor in it: the file formats are
byte-compatible with the reference pipeline's (so its checked-in dumps and
goldens can be consumed directly for cross-validation), and the device-side
code never touches files.
"""

from mqslam_tpu_torch.io import tum, pcd, intrinsics, ba_info  # noqa: F401
