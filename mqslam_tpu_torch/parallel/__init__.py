"""Sharding over a ``torch.distributed`` process group: the observation
factors of a BA problem over ranks (``sharded_ba``, all-reduce assembly of
the reduced camera system), the agents of a fleet over ranks (``fleet``,
no collectives), process start-up (``multihost``) and a multi-process dry
run of the whole fleet -> merge -> joint-BA pipeline (``dryrun``).

The JAX package shards over a ``jax.sharding.Mesh`` axis with
``shard_map`` + ``psum``; here one process drives one device, and every
``psum`` is an ``all_reduce`` over the group.  Each CG iteration moves only
O(poses + landmarks) between ranks, never per-observation data.
"""

from mqslam_tpu_torch.parallel.sharded_ba import (  # noqa: F401
    build_layout_for_mesh, make_sharded_lm_iteration,
    pad_problem_for_shards, shard_problem_for_mesh, sharded_lm_solve,
    sharded_lm_solve_device,
)
from mqslam_tpu_torch.parallel import multihost  # noqa: F401
