"""Multi-agent collaborative SLAM: map merging + joint factor graphs.

The reference's multi-agent capability lives in its BA data model (per-camera
pose chains, cross-camera BetweenFactors: reference: Work/SLAM/tools/
bundle_adjustment/DataStructures.hpp:55-88, GenerateData.hpp:256-269) — the
fusion itself happens offline through the shared factor graph.  This package
makes that a first-class operation: rebuild per-agent dumps from a fleet run
(``fleet_dump``), merge them into one multi-camera problem (optionally
unifying co-visible landmarks) with cross-agent between factors
(``merge``), and solve jointly with the sharded BA solver
(``mqslam_tpu_torch.parallel``).  Host NumPy / SciPy, as in the JAX
package.
"""

from mqslam_tpu_torch.multiagent.merge import (  # noqa: F401
    CrossOdometry, merge_agents,
)
from mqslam_tpu_torch.multiagent.fleet_dump import (  # noqa: F401
    ba_data_from_scan, scan_to_host,
)
