"""The work counts of ``portbench.work`` against brute-force counts on
small shapes."""
import math

import numpy as np
import pytest
import torch

from portbench import work
from portbench.reference import gpt2

CFG = {"n_layer": 3, "n_embd": 32, "n_head": 4, "n_ctx": 64,
       "vocab_size": 100}


def brute_visible(seg_row):
    t = len(seg_row)
    return sum(1 for i in range(t) for j in range(i + 1)
               if seg_row[i] == seg_row[j] and seg_row[i] != 0)


@pytest.mark.parametrize("t", [1, 2, 7, 64])
def test_causal_pairs_count_the_lower_triangle(t):
    mask = torch.ones(t, t, dtype=torch.bool).tril()
    assert work.causal_pairs(t) == int(mask.sum())


@pytest.mark.parametrize("row", [[1, 1, 1, 2, 2, 3, 0, 0],
                                 [1] * 9, [1, 2, 3, 4], [0, 0, 0],
                                 [5, 5, 0, 7, 7, 7, 7]])
def test_packed_pairs_count_within_documents_and_skip_padding(row):
    assert work.packed_pairs(row) == brute_visible(row)


def test_packed_pairs_match_the_references_mask():
    rng = np.random.default_rng(0)
    seg = torch.from_numpy(np.sort(rng.integers(0, 5, (3, 40)), axis=1))
    mask = gpt2.visible(seg, 40, "cpu")[:, 0]
    real = (seg != 0)[:, :, None]
    assert sum(work.packed_pairs(r) for r in seg.tolist()) == \
        int((mask & real).sum())


def test_matmul_params_count_the_references_matrices():
    shapes = gpt2.param_shapes(CFG)
    mats = sum(math.prod(s) for n, s in shapes.items()
               if n.endswith(".w"))
    # the head multiplies by the published vocabulary's rows of wte
    assert work.matmul_params(CFG) == mats + CFG["vocab_size"] * CFG["n_embd"]


def test_attention_flops_count_every_multiply_add():
    t, d, h = 10, CFG["n_embd"] // CFG["n_head"], CFG["n_head"]
    pairs = work.causal_pairs(t)
    # forward: each visible pair takes a D-long dot for its score and a
    # D-long axpy of its value: 2 products of 2 D FLOPs
    fwd = 0
    for i in range(t):
        for j in range(i + 1):
            fwd += 2 * d + 2 * d
    fwd *= h * CFG["n_layer"]
    assert work.attention_flops(pairs, CFG, backward=False) == fwd
    assert work.attention_flops(pairs, CFG, backward=True) == 3 * fwd


def test_train_step_flops_are_six_per_weight_per_token_plus_attention():
    tok, pairs = 1000, 5000
    assert work.train_step_flops(CFG, tok, pairs) == \
        6 * work.matmul_params(CFG) * tok + \
        work.attention_flops(pairs, CFG, True)


def test_attention_call_bytes_count_each_tensor_once():
    b, h, t, d = 2, 3, 5, 4
    q = torch.zeros(b, h, t, d, dtype=torch.bfloat16)
    lse = torch.zeros(b, h, t, dtype=torch.float32)
    seg = torch.zeros(b, t, dtype=torch.int32)
    size = q.numel() * q.element_size()
    fwd = 4 * size + lse.numel() * 4          # q k v in, o out, lse out
    bwd = 5 * size + lse.numel() * 4 + 3 * size   # q k v o dO lse in; dq dk dv
    assert work.attention_call_bytes(b, h, t, t, d, 2, False) == fwd + bwd
    segs = 2 * 2 * seg.numel() * 4            # q and k ids, each pass
    assert work.attention_call_bytes(b, h, t, t, d, 2, True) == \
        fwd + bwd + segs


def test_least_seconds_take_the_larger_bound():
    assert work.least_seconds(989e12, 0, 989e12) == 1.0
    assert work.least_seconds(0, 3.35e12, 989e12) == 1.0
    assert work.least_seconds(989e12, 2 * 3.35e12, 989e12) == 2.0


def test_paged_attention_bytes_gather_every_resident_row_once():
    page, kv, d, h = 4, 2, 8, 4
    ctx = [0, 3, 9, 16]
    pages = torch.zeros(20, page, kv, d)
    table = torch.zeros(len(ctx), 5, dtype=torch.int32)
    read = 0
    for c in ctx:
        rows = pages.reshape(-1, kv, d)[:c]
        read += 2 * rows.numel() * rows.element_size()
    qo = 2 * len(ctx) * h * d * 4
    want = read + qo + table.numel() * 4 + len(ctx) * 4
    assert work.paged_attention_bytes(ctx, kv, d, 4, h, 4,
                                      table.numel()) == want


def test_decode_and_prefill_flops():
    d = CFG["n_embd"] // CFG["n_head"]
    n = work.matmul_params(CFG)
    assert work.decode_flops(CFG, 7) == \
        2 * n + 4 * d * 7 * CFG["n_head"] * CFG["n_layer"]
    assert work.decode_flops(CFG, 7, 5) == \
        sum(work.decode_flops(CFG, 7 + k) for k in range(5))
    head = CFG["vocab_size"] * CFG["n_embd"]
    p = 11
    assert work.prefill_flops(CFG, p) == \
        2 * (n - head) * p + 2 * head + \
        work.attention_flops(work.causal_pairs(p), CFG, False)


def test_peaks_are_the_data_sheets():
    assert work.PEAK_FLOPS["bfloat16"] == 989e12
    assert work.PEAK_FLOPS["float32"] == 67e12
    assert work.HBM_BYTES_PER_S == 3.35e12
