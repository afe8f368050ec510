"""Multi-process distributed BA over ``torch.distributed``.

The counterpart of the JAX package's multi-host layer: one process a
device, one process group over every process, and the same sharded LM
iteration as the single-process path (``sharded_lm_solve`` takes any
group), so the only multi-process specifics are process initialization and
the group.

Traffic shape: observation factors shard over the group's ranks, while the
collectives of a CG iteration carry only the replicated O(poses +
landmarks) reduced-system vectors.

Usage (one process per device):

    from mqslam_tpu_torch.parallel import multihost
    multihost.initialize("tcp://HOST:PORT", num_processes, process_id)
    with multihost.global_group() as group:
        v, hist = multihost.solve(problem, group)

NCCL, the backend for CUDA tensors, takes one rank a GPU: two ranks cannot
share one card.  Nothing here falls back to another backend.
"""

import contextlib
import datetime
import socket

import torch.distributed as dist

from mqslam_tpu_torch.parallel.sharded_ba import sharded_lm_solve

__all__ = ["initialize", "global_group", "solve", "backend_for",
           "free_port"]


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``: NCCL for a CUDA
    device, gloo for the CPU."""
    return "nccl" if str(device).startswith("cuda") else "gloo"


def free_port() -> int:
    """A TCP port free on 127.0.0.1 at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend: str = "nccl",
               timeout_s: float = 120.0):
    """``dist.init_process_group`` wrapper (a no-op returning False for a
    single process with no coordinator, so the same script runs
    anywhere).  ``coordinator_address`` is ``tcp://HOST:PORT`` (or
    ``HOST:PORT``); a collective that waits longer than ``timeout_s``
    fails instead of hanging.  Raises when ``backend`` is not available in
    this build of torch."""
    if coordinator_address is None and num_processes in (None, 1):
        return False
    available = {"nccl": dist.is_nccl_available,
                 "gloo": dist.is_gloo_available}
    if backend not in available or not available[backend]():
        raise RuntimeError(f"the {backend!r} backend of torch.distributed "
                           "is not available in this torch build")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


@contextlib.contextmanager
def global_group(backend: str = "nccl"):
    """The group of every process (``dist.group.WORLD``), the counterpart of
    the JAX package's ``global_mesh``.  After ``initialize``, the world it
    made; in a process with no group yet, a one-rank group over a free
    localhost port, started here and destroyed on exit."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def solve(problem, group=None, **kwargs):
    """The sharded LM solve over ``group`` (None: ``global_group`` with the
    backend of the problem's device).

    Every process must call this with the SAME replicated problem: each
    keeps its own observation rows, and the accept / reject decisions are
    the same on every process because the reduced costs are."""
    if group is not None:
        return sharded_lm_solve(problem, group, **kwargs)
    with global_group(backend_for(problem.device)) as g:
        return sharded_lm_solve(problem, g, **kwargs)
