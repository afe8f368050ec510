"""Shared arithmetic of the fleet runner's span readers: the program's own
span totals (``mqslam_tpu_torch.utils.profiling.span_stats``), which a
traced run fills in its profiled groups only (the window's groups run with
tracing off)."""


def stats(trace):
    """{span name: totals} of the fleet runner's spans; None without a
    profiled window or where the program records no spans."""
    if trace.get("window_s", 0) <= 0:
        return None
    from mqslam_tpu_torch.utils import profiling
    read = getattr(profiling, "span_stats", None)
    return read("fleet.") if read is not None else None


def per_group(trace, name, field, absent=None):
    """Span ``name``'s ``field`` summed over the profiled frame-groups (the
    count of ``fleet.track_phase``), over their number; ``absent`` where
    the span was never recorded, None where no group was."""
    s = stats(trace)
    groups = (s or {}).get("fleet.track_phase", {}).get("count")
    if not groups:
        return None
    return s[name][field] / groups if name in s else absent
