"""Training traffic: documents of random tokens whose lengths are
``doc_len`` quantiles, packed into a pool of ``pool`` batches of
``batch`` rows of ``seq_len`` with segment ids by the program's own
packer (``gpt.pack_sequences``)."""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.generate import quantile_lengths, rng


def documents(mix, vocab, seed):
    """Random-token documents of the mix's quantile lengths, in the
    seed's order: enough for ``over`` times the pool's tokens at their
    mean length."""
    need = mix["pool"] * mix["batch"] * mix["seq_len"]
    mean = statistics.fmean(quantile_lengths(mix["doc_len"], 1000))
    lengths = quantile_lengths(mix["doc_len"],
                               int(math.ceil(mix["over"] * need / mean)))
    r = rng(seed, 2)
    order = r.permutation(len(lengths))
    return [r.integers(0, vocab, lengths[i], dtype=np.int32)
            for i in order]


def batches(mix, cfg, seed, device):
    """``[(x, y, segments)]``: ``pool`` batches of rows packed by the
    program's ``gpt.pack_sequences``; the label of each position is the
    next token along the row (0 past its end)."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    b, t, pool = mix["batch"], mix["seq_len"], mix["pool"]
    toks, segs = gpt.pack_sequences(
        documents(mix, cfg["vocab_size"], seed), t)
    if len(toks) < pool * b:
        raise ValueError("packing gave %d rows, the pool needs %d"
                         % (len(toks), pool * b))
    x = torch.from_numpy(np.asarray(toks[:pool * b], np.int64)).to(device)
    seg = torch.from_numpy(np.asarray(segs[:pool * b], np.int32)).to(device)
    y = torch.zeros_like(x)
    y[:, :-1] = x[:, 1:]
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b],
             seg[i * b:(i + 1) * b]) for i in range(pool)]
