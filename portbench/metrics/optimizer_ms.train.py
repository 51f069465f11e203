"""Device time per step of what ``Trainer.step`` launched, in the
profiled steps."""


def read(t):
    if "flops_per_step" not in t:
        return None
    dev = t["timeline"].range_device_s("portbench.trainer_step",
                                       backward=False)
    if dev <= 0:
        return None
    return dev / t["steps"] * 1e3
