"""Milliseconds of the fleet runner's track phase per frame-group
(``stage_ms["track_phase"]``, each stage closed by a synchronize), the
mean over the traced window's groups."""


def read(trace):
    groups = trace.get("stage_ms") or []
    vals = [g["track_phase"] for g in groups if "track_phase" in g]
    return sum(vals) / len(vals) if vals else None
