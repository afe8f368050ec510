"""Bundle adjustment: factor-graph LM with Schur-complement reduction.

Projection / between / prior factors over Cal3DS2 cameras, damped
Gauss-Newton with the landmarks marginalized and the reduced camera system
solved by a dense Cholesky (``solver.solve_delta_dense``) or, past the
dense path's size gates, by matrix-free Schur PCG (``solver.solve_delta``)
over the COO, packed (``packed``) or banded (``banded``) observation
layouts; a float64 finishing pass on the host (``polish64``); the
step-batched incremental solve (``incremental``).  The solver's ``group``
path and the sharded layouts serve the sharded solve
(``mqslam_tpu_torch.parallel.sharded_ba``); the pose graph waits for
ROADMAP Queue 1 item 13.
"""

from mqslam_tpu_torch.ba.problem import (  # noqa: F401
    BAProblem, BAVariables, problem_from_ba_data,
)
from mqslam_tpu_torch.ba.solver import ba_solve, lm_solve  # noqa: F401
