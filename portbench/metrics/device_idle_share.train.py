"""Share of the profiled training steps' wall time in which no device
activity ran: 1 - (union of activity intervals) / window."""


def read(t):
    if "flops_per_step" not in t:
        return None
    return 100.0 * t["timeline"].idle_share
