"""Attention's least time over its device time in the profiled steps.

The least time is the larger of its FLOPs over the peak and its bytes
over HBM bandwidth, counted from the shapes of every call of the
attention op and its visible pairs (``portbench.work``).  The device time
is every activity launched inside the harness's range around the op, or
inside the backward of what ran there."""
from portbench import work


def read(t):
    if not t.get("attn_calls"):
        return None
    dev = t["timeline"].range_device_s("portbench.attention")
    if dev <= 0:
        return None
    least = work.least_seconds(t["attn_flops"], t["attn_bytes"],
                               t["peak_flops"])
    return 100.0 * least / dev
