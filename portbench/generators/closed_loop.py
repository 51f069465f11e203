"""Serving traffic: a closed loop of ``clients`` clients, each sending its
next request as soon as the last one finished, with ``prompt_len`` and
``output_len`` quantiles, ``prompt + output <= max_total``, and a
pre-aged first wave (``preage``).  The seed draws the tokens."""
from __future__ import annotations

import numpy as np

from portbench.generate import quantile_lengths, rng


#: seeds the length schedule, which is the same for every run
SCHEDULE = 0x5EED


class Requests:
    """The requests of a closed loop of ``clients`` clients.

    The (prompt, output) length pairs are a fixed set: ``clients *
    per_client`` quantiles of each length, paired and dealt out to the
    clients by a fixed shuffle.  A client's ``j``-th request is
    :meth:`request` ``(c, j)``; past its share it starts over on its
    list.  The seed draws every token.

    The first wave is pre-aged: client ``c``'s first request carries a
    share ``u_c`` (uniform quantiles, in a fixed order) of its output
    budget as extra prompt, and that much less output, so completions
    spread over time as in a server that has been running.

    The schedule of lengths is the same for every seed: in a closed loop
    its order decides which requests finish in the same step and so wait
    together for their prefills, and the first-token tail follows that.
    """

    def __init__(self, mix, vocab, seed):
        self.mix, self.vocab, self.seed = mix, vocab, int(seed)
        n = mix["clients"] * mix["per_client"]
        prompts = quantile_lengths(mix["prompt_len"], n)
        outputs = quantile_lengths(mix["output_len"], n)
        fixed = rng(SCHEDULE, n).permutation(n)
        pairs = [(p, min(outputs[fixed[i]], mix["max_total"] - p))
                 for i, p in enumerate(prompts)]
        order = rng(SCHEDULE, 3).permutation(n)
        self.pairs = [pairs[i] for i in order]
        c = mix["clients"]
        self.age = [(k + 0.5) / c for k in rng(SCHEDULE, 4).permutation(c)]
        self.sent = [0] * c

    def request(self, client, j):
        """``(prompt int32 [P], max_new)`` of client ``client``'s ``j``-th
        request."""
        per = self.mix["per_client"]
        p, o = self.pairs[client * per + j % per]
        if j == 0 and self.mix.get("preage"):
            extra = min(int(self.age[client] * o), o - 1)
            p, o = p + extra, o - extra
        toks = rng(self.seed, 5, client, j).integers(
            0, self.vocab, p, dtype=np.int32)
        return toks, o

    def _next(self, client):
        prompt, max_new = self.request(client, self.sent[client])
        self.sent[client] += 1
        return client, prompt, max_new, None

    def start(self, now):
        """Every client's first request."""
        return [self._next(c) for c in range(self.mix["clients"])]

    def after_step(self, now, finished):
        """The next request of every client whose request finished."""
        return [self._next(c) for c in sorted(finished)]
