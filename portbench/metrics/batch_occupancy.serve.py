"""Mean, over the window's decode steps, of the slots that advanced over
all slots."""
import statistics


def read(t):
    xs = t.get("occupancy")
    if not xs:
        return None
    return 100.0 * statistics.fmean(xs)
