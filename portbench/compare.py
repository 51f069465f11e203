"""The numbers that decide ``correct``, each held to a limit of its own.

Training (the program's first steps against the plain reference's, from
the same weights and batches):

- ``loss_gap``: the largest gap between the two losses of a step, in
  nats;
- ``grad_gap``: the first step's gradient, leaf by leaf: the gap between
  the program's norm and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger; the worst leaf;
- ``delta_gap``: the same for the change of every weight over the first
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position (see
:mod:`portbench.drivers.serve`).
"""
from __future__ import annotations

import math
import statistics

#: leaves whose reference gradient norm is under this share of the
#: median leaf's are left out of ``delta_gap``
STILL_LEAF = 1e-3


def _worst_leaf(got, want, leaves):
    floor = statistics.median(want[n] for n in want)
    worst = 0.0
    for n in leaves:
        gap = abs(got[n] - want[n]) / max(want[n], floor)
        if math.isnan(gap):
            return float("nan")
        worst = max(worst, gap)
    return worst


def training_numbers(got, want):
    """``{name: value}`` of a run's readings ``got`` against the
    reference's ``want`` (both as :func:`portbench.reference.gpt2.train`
    returns them)."""
    loss = max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))
    gfloor = statistics.median(want["grad_norms"].values())
    moving = [n for n, g in want["grad_norms"].items()
              if g >= STILL_LEAF * gfloor]
    return {"loss_gap": loss,
            "grad_gap": _worst_leaf(got["grad_norms"], want["grad_norms"],
                                    list(want["grad_norms"])),
            "delta_gap": _worst_leaf(got["delta_norms"], want["delta_norms"],
                                     moving)}


def held(numbers, limits):
    """``{name: {"value": v, "limit": l}}`` in the order of ``limits``."""
    return {n: {"value": numbers[n], "limit": limits[n]} for n in limits}


def training(got, want, limits):
    return held(training_numbers(got, want), limits)


def passes(checks):
    """True when every number is within its limit (NaN is not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
