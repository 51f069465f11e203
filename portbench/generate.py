"""What every traffic generator shares.

A mix is a data file ``traffic/<mix>.json`` of parameters.  Its ``kind``
names the form of its traffic, and the form is a module of its own,
``generators/<kind>.py``, which the harness finds by that name
(:meth:`portbench.spec.Cell.generator`).  A training form gives
``batches(mix, cfg, seed, device) -> [(x, y, segments or None)]``; a
serving form gives a class ``Requests(mix, vocab, seed)`` with
``start(now)`` and ``after_step(now, finished)``, each returning the
requests to submit as ``(key, prompt, max_new, due)`` (see
:mod:`portbench.drivers.serve`).  A new mix of a known form is a data
file; a new form is a new module.

Lengths are a fixed set of quantiles of their distribution, the same for
every seed, and the seed draws every token; where the order of the
lengths changes what is measured, as in a closed loop, the order is
fixed too.  So runs of different seeds spread no more than runs of one
seed.
"""
from __future__ import annotations

import math
import statistics

import numpy as np


def quantile_lengths(dist, n):
    """``n`` lengths at the midpoint quantiles ``(i + 0.5) / n`` of a
    lognormal of ``median`` and ``sigma``, rounded and clipped to
    ``[min, max]``; in increasing order."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        x = dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


def rng(*key):
    """A numpy generator for ``key``; seeds of any size fold into 63
    bits."""
    return np.random.default_rng([int(k) % (2 ** 63) for k in key])
