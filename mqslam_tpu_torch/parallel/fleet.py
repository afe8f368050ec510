"""Fleet front-end: the multi-agent tracker split over ranks.

The single-device multi-agent runner (``frontend.tracker.
make_multi_agent_runner``) tracks A agents concurrently, all agents' tracks
through one shared LK call a frame.  This module splits that A axis over
the ranks of a process group: agents are data-parallel (SLAM front-ends
never communicate; collaboration happens in the joint BA,
``mqslam_tpu_torch.multiagent`` + ``parallel.sharded_ba``), so each rank
runs the whole runner on its own A / n agents with ZERO collectives, the
counterpart of the JAX package's ``shard_map`` over the agent axis.
Per-agent results reach the other ranks later, as BA dumps
(``torch.distributed.all_gather_object``).

No counterpart exists in the reference (one Python 2 process per camera);
the semantics are "N independent slam2.py front-ends" batched per device.
"""

import torch.distributed as dist

from mqslam_tpu_torch.core import camera as cam_mod
from mqslam_tpu_torch.frontend import tracker as trk

__all__ = ["make_fleet_runner", "shard_agents"]


def _span(A: int, rank: int, world: int):
    if A % world:
        raise ValueError(f"{A} agents do not split over {world} ranks")
    return rank * A // world, (rank + 1) * A // world


def shard_agents(states, imgs, rank: int, world: int):
    """Rank ``rank`` of ``world``'s agents ``[rank*A/world,
    (rank+1)*A/world)`` of A-leading tracker states and image stacks
    [A, T+1, H, W]; A must be divisible by ``world``."""
    lo, hi = _span(imgs.shape[0], rank, world)
    return trk.TrackerState(*(x[lo:hi] for x in states)), imgs[lo:hi]


def make_fleet_runner(cal: cam_mod.Cal3DS2, config: trk.TrackerConfig,
                      group=None, collect: bool = False, device=None,
                      shard=None):
    """Fleet runner: (states [A-stacked], imgs [A, T+1, H, W],
    ransac_scores=None [T, A, n_hyp, K], generator=None, stage_ms=None) ->
    (final states, per-frame outputs) of THIS rank's agents, on ``device``
    (None: the CUDA device).

    ``group`` (the JAX package's mesh axis) gives the rank and the number
    of ranks; ``shard=(rank, world)`` gives them without a process group
    (one process can then run every rank's share).  Each rank takes its
    agents (``shard_agents``, and its columns of ``ransac_scores``) and
    runs ``make_multi_agent_runner`` on them, with no collective.  With one
    rank this is ``make_multi_agent_runner`` itself.  ``collect=True`` adds
    the per-frame track-level outputs from which each agent's BA dump is
    rebuilt (``multiagent.fleet_dump``)."""
    if group is not None and shard is not None:
        raise ValueError("give a process group or shard=(rank, world), "
                         "not both")
    if group is not None:
        shard = (dist.get_rank(group), dist.get_world_size(group))
    rank, world = shard if shard is not None else (0, 1)
    run_local = trk.make_multi_agent_runner(cal, config, collect=collect,
                                            device=device)
    if world == 1:
        return run_local

    def fleet(states, imgs, ransac_scores=None, generator=None,
              stage_ms=None):
        lo, hi = _span(imgs.shape[0], rank, world)
        st, im = shard_agents(states, imgs, rank, world)
        sc = None if ransac_scores is None else ransac_scores[:, lo:hi]
        return run_local(st, im, sc, generator, stage_ms)

    return fleet
