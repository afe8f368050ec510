"""Milliseconds of device time that NCCL's kernels take on rank 0's card
in a joint refine job's first outer iteration, the traced run's profiled
part: the collectives' share of the card, their waits for the slowest
rank included.  A kernel is NCCL's by its name (``ncclDevKernel_...``,
``ncclKernel_...`` in older NCCL); the profiler's annotation of the same
interval (``nccl:all_reduce``) is not counted again."""

KERNELS = ("ncclDevKernel", "ncclKernel")


def read(trace):
    jobs = trace.get("recorded", {}).get("jobs")
    t = sum(s for name, (s, _) in trace.get("kernels", {}).items()
            if name.startswith(KERNELS))
    if not jobs or t <= 0:
        return None
    return 1e3 * t / jobs
