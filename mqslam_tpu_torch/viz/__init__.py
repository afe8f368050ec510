"""Visualization exports.

The reference visualizes through Blender importers driven by plain files
(reference: Work/python_libs/blender_tools.py — keyframed camera
trajectories from TUM files :206-320, point clouds from PCD :447-499, and a
live file-watcher :501-596). Our TUM/PCD writers are byte-compatible, so
that Blender tooling consumes this framework's outputs unchanged; this
package adds PLY export (the pcd2ply role, dataset_tools.py:215-218 note)
and the periodic live-output hook used by the front-end runner.
"""

from mqslam_tpu_torch.viz.colors import (  # noqa: F401
    color_palette, sample_colors,
)
from mqslam_tpu_torch.viz.ply import save_ply  # noqa: F401
