"""Shared arithmetic of the BA solver's span readers: the program's own
span totals (``mqslam_tpu_torch.utils.profiling.span_stats``), which a
traced run fills in its profiled job(s) only (the window's jobs run with
tracing off)."""


def per_job(trace, name, field, absent=None):
    """Span ``name``'s ``field`` summed over the profiled refine jobs (the
    count of ``ba.lm``), over their number; ``absent`` where the span was
    never recorded, None where no job was profiled or the program records
    no spans."""
    if trace.get("window_s", 0) <= 0:
        return None
    from mqslam_tpu_torch.utils import profiling
    read = getattr(profiling, "span_stats", None)
    s = read("ba.") if read is not None else {}
    jobs = s.get("ba.lm", {}).get("count")
    if not jobs:
        return None
    return s[name][field] / jobs if name in s else absent
