"""Model FLOPs per training step over the step time, as a share of the
chip's dense peak in the cell's compute precision.  The step time is the
traced run's, over its steps outside the profiled slice."""


def read(t):
    if "flops_per_step" not in t:
        return None
    return 100.0 * t["flops_per_step"] / t["step_s"] / t["peak_flops"]
