"""Share of the profiled front-end sub-window in which no operation ran on
the device, in percent."""


def read(trace):
    if trace.get("window_s", 0) <= 0 or "busy_s" not in trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
