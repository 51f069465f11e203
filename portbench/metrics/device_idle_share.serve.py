"""Share of the profiled engine steps' wall time in which no device
activity ran: 1 - (union of activity intervals) / window."""


def read(t):
    if "paged_calls" not in t:
        return None
    return 100.0 * t["timeline"].idle_share
