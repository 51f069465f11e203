"""Host time of one prefill, launch and sync: the mean of t2 - t0 over
the engine's ``serve_prefill`` flight records, over the traced window
outside the profiled slice."""
import statistics


def read(t):
    xs = t.get("prefill_s")
    if not xs:
        return None
    return statistics.fmean(xs) * 1e3
