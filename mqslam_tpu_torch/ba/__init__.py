"""Bundle adjustment: factor-graph LM with Schur-complement reduction.

Projection / between / prior factors over Cal3DS2 cameras, damped
Gauss-Newton with the landmarks marginalized and the reduced camera system
solved by a dense Cholesky (``solver.solve_delta_dense``), then a float64
finishing pass on the host (``polish64``).  The JAX package's matrix-free
PCG path, its layouts, the sharded and incremental solves and the pose
graph wait for ROADMAP Queue 1 items 11-13.
"""

from mqslam_tpu_torch.ba.problem import (  # noqa: F401
    BAProblem, BAVariables, problem_from_ba_data,
)
from mqslam_tpu_torch.ba.solver import ba_solve, lm_solve  # noqa: F401
