"""Paged attention's least time over its device time in the profiled
engine steps.  The least time is the bytes bound: the K and V of every
resident token, q, the output, the block table and the context lengths,
each counted once (``portbench.work.paged_attention_bytes``).  The device
time is every activity launched inside the harness's range around the
decode step's paged-attention call."""
from portbench import work


def read(t):
    if not t.get("paged_calls"):
        return None
    dev = t["timeline"].range_device_s("portbench.paged_attention",
                                       backward=False)
    if dev <= 0:
        return None
    return 100.0 * work.least_seconds(0, t["paged_bytes"], 1.0) / dev
