"""Shared arithmetic of the LK kernels' roofline readers."""

from benchmark import bounds


def roofline(trace, kernel, name_part):
    """Percent of the bytes bound of the recorded ``kernel`` calls over the
    device time of the kernels whose name holds ``name_part``; None when
    the trace holds neither."""
    calls = [c for c in trace.get("recorded", {}).get("lk_calls", [])
             if c["kernel"] == kernel]
    busy = sum(s for name, (s, _) in trace.get("kernels", {}).items()
               if name_part in name)
    if not calls or busy <= 0:
        return None
    bound = sum(bounds.lk_level_seconds(
        c["numel"], c["px"], c["tracks"], int((c["valid"] != 0).sum()),
        c["win"], c["hiX"]) for c in calls)
    return 100.0 * bound / busy
