"""Shared arithmetic of the sharded BA's readers: the program's own span
and counter totals (``mqslam_tpu_torch.utils.profiling``), which a traced
run fills on rank 0 in the whole job(s) it runs with the program's
tracing on after the profiled part (the window's jobs run with tracing
off)."""


def _jobs(trace, s):
    if trace.get("window_s", 0) <= 0:
        return None
    return s.get("ba.sharded.lm", {}).get("count") or None


def _stats():
    from mqslam_tpu_torch.utils import profiling
    read = getattr(profiling, "span_stats", None)
    return read("ba.sharded.") if read is not None else {}


def per_job(trace, name, field):
    """Span ``name``'s ``field`` summed over the profiled jobs (the count
    of ``ba.sharded.lm``), over their number; None where no job was
    profiled, the program records no such span, or the span is absent."""
    s = _stats()
    jobs = _jobs(trace, s)
    if not jobs or name not in s:
        return None
    return s[name][field] / jobs


def counter_per_job(trace, name):
    """Counter ``name``'s total over the profiled jobs, over their number;
    None where the program keeps no such counter."""
    from mqslam_tpu_torch.utils import profiling
    jobs = _jobs(trace, _stats())
    read = getattr(profiling, "counter_stats", None)
    if not jobs or read is None:
        return None
    c = read(name).get(name)
    return c["total"] / jobs if c is not None else None
