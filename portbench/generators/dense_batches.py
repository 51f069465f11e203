"""Training traffic: a pool of ``pool`` batches of ``batch`` rows of
``seq_len + 1`` random tokens (inputs and next-token labels), drawn on
the device in one call."""
from __future__ import annotations

import torch

from portbench.weights import generator


def batches(mix, cfg, seed, device):
    """``[(x, y, None)]``: ``pool`` batches, int64 ``[batch, seq_len]``."""
    b, t, pool = mix["batch"], mix["seq_len"], mix["pool"]
    toks = torch.randint(0, cfg["vocab_size"], (pool, b, t + 1),
                         device=device,
                         generator=generator(seed, device, stream=1))
    return [(toks[i, :, :-1], toks[i, :, 1:], None) for i in range(pool)]
