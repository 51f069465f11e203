"""Needed model FLOPs of everything served (prefills of the prompts and
one decode per output token, attention over each token's context) over
the traced window's time outside the profiled slice, as a share of the
chip's peak in the cell's precision (float32)."""


def read(t):
    if not t.get("timed_s") or "flops" not in t:
        return None
    return 100.0 * t["flops"] / t["timed_s"] / t["peak_flops"]
