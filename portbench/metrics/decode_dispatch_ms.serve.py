"""Host time to issue one decode step: the mean of the engine's
``serve_step`` flight records' launch window (t1 - t0), over the traced
window outside the profiled slice."""
import statistics


def read(t):
    xs = t.get("decode_dispatch_s")
    if not xs:
        return None
    return statistics.fmean(xs) * 1e3
