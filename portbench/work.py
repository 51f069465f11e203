"""Work counts and the peaks they are held against.

Every count is what the inputs need, computed from shapes and from the
visible (query, key) pairs, not what an implementation happens to do:
padding, masked-out pairs and recomputation are not counted.

Peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense rates
without sparsity, at the full 700 W power limit).
"""
from __future__ import annotations

#: FLOP/s of the tensor cores in bf16/fp16 and of the CUDA cores in fp32
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12


def matmul_params(cfg):
    """Weights that take part in a matrix product for every token: the
    four projections of each block (12 C^2) and the tied head over the
    published vocabulary.  Biases, LayerNorms and the embedding lookups
    are not products."""
    c = cfg["n_embd"]
    return 12 * c * c * cfg["n_layer"] + cfg["vocab_size"] * c


def causal_pairs(t):
    """Visible (query, key) pairs of one causal row of length ``t``."""
    return t * (t + 1) // 2


def packed_pairs(segment_row):
    """Visible pairs of one packed row: causal within each document.
    Segment id 0 marks padding, which needs no attention."""
    total, run, prev = 0, 0, None
    for s in list(segment_row) + [None]:
        if s == prev:
            run += 1
            continue
        if prev is not None and prev != 0:
            total += causal_pairs(run)
        prev, run = s, 1
    return total


def attention_flops(pairs, cfg, backward):
    """Products of attention over ``pairs`` visible pairs in every head of
    every layer: Q K^T and P V forward (4 D per pair); dV, dP, dQ, dK
    backward (8 D per pair).  Recomputing Q K^T in the backward is not
    counted."""
    d = cfg["n_embd"] // cfg["n_head"]
    per_pair = (4 + (8 if backward else 0)) * d
    return per_pair * pairs * cfg["n_head"] * cfg["n_layer"]


def train_step_flops(cfg, tokens, pairs):
    """Model FLOPs of one training step: 6 per matrix weight per real
    (non-padding) token, plus attention over the visible pairs."""
    return 6 * matmul_params(cfg) * tokens + attention_flops(pairs, cfg, True)


def attention_call_bytes(b, h, tq, tk, d, itemsize, segmented):
    """Bytes one attention call and its backward must move, each input
    read once and each output written once: forward q, k, v in, o and the
    fp32 log-sum-exp out; backward q, k, v, o, dO and the log-sum-exp in,
    dQ, dK, dV out; int32 segment ids in for each pass."""
    q, kv, lse = b * h * tq * d, b * h * tk * d, b * h * tq
    fwd = (q + 2 * kv + q) * itemsize + 4 * lse
    bwd = (q + 2 * kv + 2 * q) * itemsize + 4 * lse + (q + 2 * kv) * itemsize
    seg = 2 * 4 * b * (tq + tk) if segmented else 0
    return fwd + bwd + seg


def least_seconds(flops, nbytes, peak_flops):
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def paged_attention_bytes(contexts, kv_heads, head_dim, kv_itemsize,
                          q_heads, q_itemsize, table_entries):
    """Bytes of one paged-attention decode call: the K and V of every
    resident token of every slot, q and the output, the block table and
    the context lengths, each counted once."""
    slots = len(contexts)
    kv = sum(contexts) * kv_heads * head_dim * 2 * kv_itemsize
    qo = 2 * slots * q_heads * head_dim * q_itemsize
    return kv + qo + 4 * table_entries + 4 * slots


def decode_flops(cfg, context, n=1):
    """FLOPs to decode ``n`` tokens of one request, the first of which
    sees ``context`` keys and each later one a key more."""
    d = cfg["n_embd"] // cfg["n_head"]
    keys = n * context + n * (n - 1) // 2
    return (2 * matmul_params(cfg) * n
            + 4 * d * keys * cfg["n_head"] * cfg["n_layer"])


def prefill_flops(cfg, prompt_len):
    """FLOPs a prompt of ``prompt_len`` tokens needs: every block over
    every token, causal attention, and the head at the last position
    only (the first token is all a prefill returns)."""
    head = cfg["vocab_size"] * cfg["n_embd"]
    body = matmul_params(cfg) - head
    return (2 * body * prompt_len + 2 * head
            + attention_flops(causal_pairs(prompt_len), cfg, False))
