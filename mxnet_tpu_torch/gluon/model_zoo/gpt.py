"""GPT-2-class decoder language models: the model half, the training
forward and the serving programs of ``mxnet_tpu/gluon/model_zoo/gpt.py``,
in PyTorch.

Model half: :class:`GPTBlock` and :class:`GPTLM` are Gluon
:class:`~..block.HybridBlock` blocks with the reference's ``hybrid_forward``
(pre-LN blocks, head-major fused qkv, gelu-tanh MLP at 4x width, tied
embedding head, vocab padded to a multiple of 128) and its parameter
names (``gptlm0_h_gptblock0_attn_qkv_weight``, ...).  Fed NDArrays they
run eager or, after ``hybridize()``, as the traced CachedOp (the stack
reads ``tokens.shape``, so it does not trace symbolically); fed raw torch
tensors they run the same ``hybrid_forward`` over tensors, the reference's
raw-array dispatch.  Every block's attention is
``F._contrib_flash_attention``, the flash kernels (B1 forward, B2 + B3 or
B7 backward), with sequence packing through :func:`pack_sequences` /
:func:`packed_positions` and dropout (``F.Dropout``).  ``remat=True``
recomputes each block's activations in the backward
(``torch.utils.checkpoint``) on the raw-tensor path, as the reference
rematerializes on its traced path only.  Weights arrive through
``initialize``, :func:`load_jax_params` (arrays in memory) or the
Block's ``load_params`` (a V2 ``.params`` file) and leave through
``save_params``.

Serving half, the same math as the JAX package:

- :func:`decode_params` indexes the weights per layer (fp32, or cast by a
  ``PrecisionPolicy``), optionally mean-pooling K/V projections to
  ``kv_heads`` (grouped-query serving);
- :func:`paged_prefill` runs one request's prompt through a dense causal
  pass and scatters every position's K/V into its pages;
  :func:`paged_suffix_prefill` does so for the part of a prompt past a
  prefix whose pages are cached (copy-on-write of a shared boundary page
  first);
- :func:`paged_decode_step` advances every slot by one token; each layer
  launches the paged-attention kernel once
  (``mxnet_tpu_torch/ops/paged_attention.py``);
- :func:`paged_spec_decode_step` verifies each slot's last token plus up
  to ``K - 1`` draft tokens in one pass and emits the accepted run; each
  layer launches the multi-position paged kernel once;
- every program takes per-slot ``sampling`` (temperature, top-k, top-p
  and a noise key): :func:`sample_tokens`, and :func:`_spec_sample`'s
  rejection sampling under spec, draw counter-based noise that depends on
  (seed, token index) alone;
- page pools are per layer ``(k, v)`` (float32 or bfloat16) or
  ``(k, v, k_scales, v_scales)`` (int8 with fp32 ``[num_pages, K_kv]``
  absmax scales, written by :func:`_quant_scatter`);
- :func:`_prefill` and :func:`dense_logits` are the dense full-recompute
  forward, the oracle the tests and ``chip_smoke.py`` hold the paged path
  against; :func:`generate` decodes densely with a KV cache.

The JAX programs return new page pools; these update the pools IN PLACE
(PyTorch tensors are mutable and a copy of every pool per step would
double the KV traffic) and return the same list.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

from ... import autograd
from ... import random as _random
from ...context import resolve_device
from ...ndarray.ndarray import NDArray
from ...ops.paged_attention import paged_attention, paged_attention_multi
from .. import nn
from ..block import HybridBlock, current_trace, trace_scope

__all__ = ["GPTBlock", "GPTLM", "get_gpt", "gpt2_tiny", "gpt2_tiny_moe",
           "gpt2_small", "gpt2_medium", "pack_sequences",
           "packed_positions", "load_jax_params", "decode_params",
           "dense_logits", "generate", "sample_tokens", "sampling_key",
           "paged_prefill", "paged_suffix_prefill", "paged_decode_step",
           "paged_spec_decode_step"]

_NEG_INF = -1e30


class GPTBlock(HybridBlock):
    """One pre-LN decoder block: ``ln1``, ``attn`` (fused qkv + out),
    ``ln2``, and a gelu-tanh MLP ``fc1``/``fc2``; dropout after the
    attention and after the MLP."""

    def __init__(self, units, num_heads, mlp_ratio=4, dropout=0.0,
                 moe_experts=0, moe_capacity=2.0, **kwargs):
        if moe_experts:
            raise NotImplementedError(
                "mixture-of-experts blocks belong to the next slice of "
                "the port (S5b)")
        super().__init__(**kwargs)
        self._dropout = dropout
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.attn = nn.FlashSelfAttention(units, num_heads,
                                              causal=True,
                                              in_units=units,
                                              prefix="attn_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")
            self.fc1 = nn.Dense(mlp_ratio * units, flatten=False,
                                in_units=units, prefix="fc1_")
            self.fc2 = nn.Dense(units, flatten=False,
                                in_units=mlp_ratio * units, prefix="fc2_")

    def hybrid_forward(self, F, x, segments=None):
        """``x`` ``[B, T, C]`` -> ``[B, T, C]``; ``segments`` ``[B, T]``
        packing ids for the attention."""
        if segments is None:
            h = self.attn(self.ln1(x))
        else:
            h = self.attn(self.ln1(x), segments)
        if self._dropout:
            h = F.Dropout(h, p=self._dropout)
        x = x + h
        h = self.fc2(F.Activation(self.fc1(self.ln2(x)), act_type="gelu"))
        if self._dropout:
            h = F.Dropout(h, p=self._dropout)
        return x + h


def _remat_block(blk, h, segments):
    """``blk(h, segments)`` under ``torch.utils.checkpoint``: the backward
    recomputes the block's activations in the same trace (parameters,
    training mode) and with the same dropout draws (the generator's state
    of the forward is put back for the recompute)."""
    from torch.utils.checkpoint import checkpoint
    ctx = current_trace()
    gen = _random.generator(h.device)
    state = []

    def run(x, seg):
        if not state:
            state.append(gen.get_state())
            return blk(x, seg)
        saved = gen.get_state()
        gen.set_state(state[0])
        try:
            with trace_scope(ctx), autograd.record(train_mode=ctx.train):
                return blk(x, seg)
        finally:
            gen.set_state(saved)
    return checkpoint(run, h, segments, use_reentrant=False)


class GPTLM(HybridBlock):
    """Decoder-only LM: token + learned position embeddings (``wte``,
    ``wpe``), ``num_layers`` blocks under ``h_``, final LayerNorm
    ``lnf_``, output head tied to ``wte``.

    Input: int token ids ``[B, T]`` (``T <= max_len``), optionally
    ``segments`` (``[B, T]`` packing ids: every document attends within
    itself and its positions restart at 0); output: logits ``[B, T, V]``.
    ``dropout`` applies after the embeddings and inside every block while
    training."""

    def __init__(self, vocab_size, num_layers, units, num_heads,
                 max_len=1024, dropout=0.0, remat=False, moe_experts=0,
                 moe_capacity=2.0, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab_size
        self._units = units
        self._max_len = max_len
        self._dropout = dropout
        self._remat = remat
        with self.name_scope():
            self.wte = self.params.get("wte_weight",
                                       shape=(vocab_size, units))
            self.wpe = self.params.get("wpe_weight",
                                       shape=(max_len, units))
            self.blocks = nn.HybridSequential(prefix="h_")
            with self.blocks.name_scope():
                for _ in range(num_layers):
                    self.blocks.add(GPTBlock(units, num_heads,
                                             dropout=dropout,
                                             moe_experts=moe_experts,
                                             moe_capacity=moe_capacity))
            self.ln_f = nn.LayerNorm(in_channels=units, prefix="lnf_")

    @property
    def num_heads(self):
        return self.blocks[0].attn._num_heads

    def hybrid_forward(self, F, tokens, segments=None, wte=None, wpe=None):
        t = tokens.shape[1]
        if t > self._max_len:
            raise ValueError("sequence length %d exceeds max_len %d"
                             % (t, self._max_len))
        h = F.Embedding(tokens, wte, input_dim=self._vocab,
                        output_dim=self._units)
        if segments is None:
            h = h + F.slice_axis(wpe, axis=0, begin=0, end=t)
        else:
            # packed rows: positions restart at each segment boundary, so
            # every document trains with the wpe rows it sees standalone
            h = h + F.Embedding(packed_positions(segments), wpe,
                                input_dim=self._max_len,
                                output_dim=self._units)
        if self._dropout:
            h = F.Dropout(h, p=self._dropout)
        if self._remat and isinstance(h, torch.Tensor) and \
                torch.is_grad_enabled():
            for blk in self.blocks:
                h = _remat_block(blk, h, segments)
        elif segments is None:
            h = self.blocks(h)
        else:
            # HybridSequential forwards one input: thread the ids by hand
            for blk in self.blocks:
                h = blk(h, segments)
        h = self.ln_f(h)
        # tied head: one [B·T, C] x [C, V] product against the embedding
        return F.FullyConnected(h, wte, num_hidden=self._vocab,
                                no_bias=True, flatten=False)


_MODEL_PREFIX = re.compile(r"^gptlm\d+_")


def load_jax_params(net, arrays, device=None):
    """Copy ``{gluon_name: array}`` into ``net``'s parameters on
    ``device``.

    ``device`` defaults to the first CUDA card and raises without one
    unless ``"cpu"`` is asked for, as ``initialize`` does.  The names may
    carry the model's ``gptlm<N>_`` prefix (as the JAX package's
    ``net.collect_params()`` gives them) or not (as a ``.params`` file
    stores them).  Every parameter must be given exactly once with its
    exact shape; anything missing, extra or misshapen raises
    ``ValueError``.  Returns ``net``."""
    dev = resolve_device(device)
    own = {_MODEL_PREFIX.sub("", n, count=1): p
           for n, p in net.collect_params().items()}
    given = {}
    for name, value in arrays.items():
        key = _MODEL_PREFIX.sub("", name, count=1)
        if key in given:
            raise ValueError("parameter %r given twice" % key)
        given[key] = value
    missing = sorted(set(own) - set(given))
    extra = sorted(set(given) - set(own))
    if missing or extra:
        raise ValueError("parameter names do not match the model: "
                         "missing %s, unexpected %s" % (missing, extra))
    for key, p in own.items():
        a = np.array(given[key], dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError("parameter %r has shape %r, the model wants "
                             "%r" % (key, a.shape, tuple(p.shape)))
    for key, p in own.items():
        value = torch.from_numpy(np.array(given[key], dtype=np.float32))
        if p._data is not None:
            p.reset_ctx(dev)
        p.set_data(value.to(dev))
    return net


def _pad_vocab(v, mult=128):
    return (v + mult - 1) // mult * mult


def packed_positions(segments):
    """Per-row positions that restart at each segment boundary, so a packed
    document sees the same ``wpe`` rows as standalone.  ``segments``
    ``[B, T]`` (a tensor, or an NDArray for an NDArray back) -> int32
    ``[B, T]``."""
    if isinstance(segments, NDArray):
        return NDArray(packed_positions(segments._data), segments._device)
    seg = torch.as_tensor(segments)
    idx = torch.arange(seg.shape[1], device=seg.device)[None, :]
    change = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                        seg[:, 1:] != seg[:, :-1]], dim=1)
    start = torch.cummax(torch.where(change, idx, torch.zeros_like(idx)),
                         dim=1).values
    return (idx - start).to(torch.int32)


def pack_sequences(docs, seq_len, pad_id=0):
    """Pack variable-length token sequences into fixed ``[N, seq_len]``
    rows with segment ids (the reference's ``gpt.pack_sequences``, numpy).

    ``docs``: iterable of 1-d int token arrays.  Returns ``(tokens,
    segments)``, int32 ``[N, seq_len]`` each.  Segments are 1-based per
    row; 0 marks padding.  A document that would not fit the current row's
    remaining space starts a fresh row rather than being split; only
    documents longer than ``seq_len`` are split."""
    rows, segs = [], []
    cur = np.full(seq_len, pad_id, np.int32)
    cur_seg = np.zeros(seq_len, np.int32)
    pos, seg_id = 0, 1
    for doc in docs:
        doc = np.asarray(doc, np.int32)
        if 0 < seq_len - pos < doc.size <= seq_len:
            rows.append(cur)
            segs.append(cur_seg)
            cur = np.full(seq_len, pad_id, np.int32)
            cur_seg = np.zeros(seq_len, np.int32)
            pos, seg_id = 0, 1
        while doc.size:
            if pos == seq_len:
                rows.append(cur)
                segs.append(cur_seg)
                cur = np.full(seq_len, pad_id, np.int32)
                cur_seg = np.zeros(seq_len, np.int32)
                pos, seg_id = 0, 1
            take = min(doc.size, seq_len - pos)
            cur[pos:pos + take] = doc[:take]
            cur_seg[pos:pos + take] = seg_id
            pos += take
            doc = doc[take:]
        seg_id += 1
    if pos:
        rows.append(cur)
        segs.append(cur_seg)
    return np.stack(rows), np.stack(segs)


def get_gpt(num_layers, units, num_heads, vocab_size=50257, max_len=1024,
            moe_experts=0, **kwargs):
    """Build a GPTLM with the vocab padded to a multiple of 128."""
    return GPTLM(_pad_vocab(vocab_size), num_layers, units, num_heads,
                 max_len=max_len, moe_experts=moe_experts, **kwargs)


def gpt2_tiny_moe(moe_experts=4, **kwargs):
    """The 2-layer MoE test config is not ported yet (its experts belong
    to the next slice of the port, S5b)."""
    raise NotImplementedError(
        "gpt2_tiny_moe: mixture-of-experts blocks belong to the next "
        "slice of the port (S5b)")


def gpt2_tiny(**kwargs):
    """2-layer test-scale config (2 x 128, 4 heads, vocab 256)."""
    kwargs.setdefault("vocab_size", 256)
    kwargs.setdefault("max_len", 128)
    return get_gpt(2, 128, 4, **kwargs)


def gpt2_small(**kwargs):
    """124M-parameter class (12 x 768, 12 heads, vocab 50304)."""
    kwargs.setdefault("max_len", 2048)
    return get_gpt(12, 768, 12, **kwargs)


def gpt2_medium(**kwargs):
    """350M-parameter class (24 x 1024, 16 heads)."""
    kwargs.setdefault("max_len", 2048)
    return get_gpt(24, 1024, 16, **kwargs)


# ---------------------------------------------------------------------------
# decode-path parameters and layer math
# ---------------------------------------------------------------------------

def _decode_params(net):
    """fp32 copies of the net's weights indexed by layer, read from the
    live child blocks (the tree every serving program takes as ``p``)."""
    def g(param):
        return param.data()._data.detach().float().clone()

    def bias(dense):
        if dense.bias is None:
            return torch.zeros(dense._units, dtype=torch.float32,
                               device=dense.weight.data()._device)
        return g(dense.bias)

    layers = []
    for blk in net.blocks:
        layers.append({
            "ln1_g": g(blk.ln1.gamma), "ln1_b": g(blk.ln1.beta),
            "qkv_w": g(blk.attn.qkv.weight), "qkv_b": bias(blk.attn.qkv),
            "out_w": g(blk.attn.out_proj.weight),
            "out_b": bias(blk.attn.out_proj),
            "ln2_g": g(blk.ln2.gamma), "ln2_b": g(blk.ln2.beta),
            "fc1_w": g(blk.fc1.weight), "fc1_b": bias(blk.fc1),
            "fc2_w": g(blk.fc2.weight), "fc2_b": bias(blk.fc2)})
    return {"wte": g(net.wte), "wpe": g(net.wpe),
            "lnf_g": g(net.ln_f.gamma), "lnf_b": g(net.ln_f.beta),
            "layers": layers}


def _apply_precision(p, policy):
    """The tree ``p`` cast per a PrecisionPolicy (None: as it is): each
    block's tensors to the ``param`` dtype resolved for ``blocks.<i>``,
    the embeddings for ``embed`` and the final LayerNorm for ``final``."""
    if policy is None:
        return p
    out = {k: policy.cast_params(v, "embed" if k in ("wte", "wpe")
                                 else "final")
           for k, v in p.items() if k != "layers"}
    out["layers"] = [policy.cast_params(lp, "blocks.%d" % i)
                     for i, lp in enumerate(p["layers"])]
    return out


def decode_params(net, kv_heads=None, policy=None):
    """The parameter tree the serving programs take.

    ``kv_heads``: serve with ``K_kv <= H`` KV heads.  ``None`` or ``H``
    keeps the fused multi-head ``qkv_w``; a smaller divisor of ``H``
    MEAN-POOLS each group's K/V projection rows (the MHA->GQA conversion
    of the JAX package) and the layer dicts carry split
    ``q_w``/``k_w``/``v_w`` (+ biases) instead.

    ``policy``: an optional :class:`~mxnet_tpu_torch.precision.
    PrecisionPolicy` whose resolved ``param`` dtypes the tree is cast to
    (the engine's page dtype, ``policy.kv_dtype``, is the engine's)."""
    p = _decode_params(net)
    n_heads = net.num_heads
    if kv_heads is None or int(kv_heads) == n_heads:
        return _apply_precision(p, policy)
    kv_heads = int(kv_heads)
    if kv_heads < 1 or n_heads % kv_heads:
        raise ValueError(
            "kv_heads must divide the model's %d query heads, got %d"
            % (n_heads, kv_heads))
    d = int(p["wte"].shape[1]) // n_heads
    g = n_heads // kv_heads
    for lp in p["layers"]:
        w = lp.pop("qkv_w").reshape(n_heads, 3, d, -1)
        b = lp.pop("qkv_b").reshape(n_heads, 3, d)
        lp["q_w"] = w[:, 0].reshape(n_heads * d, -1)
        lp["q_b"] = b[:, 0].reshape(n_heads * d)
        for name, idx in (("k", 1), ("v", 2)):
            lp[name + "_w"] = (w[:, idx].reshape(kv_heads, g, d, -1)
                               .mean(dim=1).reshape(kv_heads * d, -1))
            lp[name + "_b"] = (b[:, idx].reshape(kv_heads, g, d)
                               .mean(dim=1).reshape(kv_heads * d))
    return _apply_precision(p, policy)


def params_to(p, device):
    """The tree ``p`` with every tensor moved to ``device``."""
    out = {k: v.to(device) for k, v in p.items() if k != "layers"}
    out["layers"] = [{k: v.to(device) for k, v in lp.items()}
                     for lp in p["layers"]]
    return out


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _block_qkv(lp, x, n_heads):
    """LN1 + fused head-major qkv: x [B, T, C] -> q, k, v [B, H, T, D]."""
    b, t, c = x.shape
    d = c // n_heads
    h = _ln(x, lp["ln1_g"], lp["ln1_b"])
    qkv = (h @ lp["qkv_w"].t() + lp["qkv_b"]).reshape(b, t, n_heads, 3, d)
    qkv = qkv.permute(0, 2, 1, 3, 4)             # [B, H, T, 3, D]
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _block_qkv_kv(lp, x, n_heads):
    """LN1 + projections with a possibly reduced KV head count: a fused
    ``qkv_w`` layer goes through :func:`_block_qkv`; a GQA-converted one
    projects q at ``H`` heads and k/v at ``K_kv``.  Returns
    ``q [B, H, T, D], k, v [B, K_kv, T, D]``."""
    if "qkv_w" in lp:
        return _block_qkv(lp, x, n_heads)
    b, t, c = x.shape
    d = c // n_heads
    kv_heads = lp["k_w"].shape[0] // d
    h = _ln(x, lp["ln1_g"], lp["ln1_b"])
    q = (h @ lp["q_w"].t() + lp["q_b"]).reshape(b, t, n_heads, d)
    k = (h @ lp["k_w"].t() + lp["k_b"]).reshape(b, t, kv_heads, d)
    v = (h @ lp["v_w"].t() + lp["v_b"]).reshape(b, t, kv_heads, d)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _bcast_kv(k, n_heads):
    """[B, K_kv, T, D] -> [B, H, T, D], each KV head repeated over its
    query group; identity when the counts agree."""
    kv_heads = k.shape[1]
    if kv_heads == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv_heads, dim=1)


def _block_finish(lp, x, o):
    """Attention output o [B, T, C] -> residual + LN2 + gelu-tanh MLP +
    residual."""
    x = x + o @ lp["out_w"].t() + lp["out_b"]
    h = _ln(x, lp["ln2_g"], lp["ln2_b"])
    h = F.gelu(h @ lp["fc1_w"].t() + lp["fc1_b"], approximate="tanh")
    return x + h @ lp["fc2_w"].t() + lp["fc2_b"]


def _causal_attention(q, k, v, mask):
    """Dense masked softmax attention, q [B, H, Tq, D] over k/v
    [B, H, Tk, D]; ``mask`` broadcasts to [B, H, Tq, Tk]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def _dense_forward(p, toks, n_heads):
    """Dense causal forward over ``toks`` [B, T]: the final-LN hidden
    states [B, T, C] and every layer's (k, v) [B, K_kv, T, D]."""
    b, t0 = toks.shape
    x = p["wte"][toks] + p["wpe"][:t0][None]           # [B, T, C]
    c = x.shape[-1]
    causal = torch.ones(t0, t0, dtype=torch.bool,
                        device=x.device).tril()[None, None]
    kvs = []
    for lp in p["layers"]:
        q, k, v = _block_qkv_kv(lp, x, n_heads)
        o = _causal_attention(q, _bcast_kv(k, n_heads),
                              _bcast_kv(v, n_heads), causal)
        x = _block_finish(lp, x, o.transpose(1, 2).reshape(b, t0, c))
        kvs.append((k, v))
    return _ln(x, p["lnf_g"], p["lnf_b"]), kvs


def _prefill(p, toks, t_max, n_heads):
    """One batched causal pass over ``toks`` [B, T0]: the last position's
    logits [B, V] and every layer's (k, v) cache padded to ``t_max``
    positions ([B, K_kv, t_max, D])."""
    h, kvs = _dense_forward(p, toks, n_heads)
    pad = t_max - toks.shape[1]
    caches = [(F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad)))
              for k, v in kvs]
    return h[:, -1] @ p["wte"].t(), caches


def dense_logits(p, toks, n_heads):
    """Teacher-forced logits at EVERY position of ``toks`` [B, T] ->
    [B, T, V]: the full-recompute oracle for the paged serving path."""
    return _dense_forward(p, toks, n_heads)[0] @ p["wte"].t()


# ---------------------------------------------------------------------------
# sampling: counter-based noise and the logit filters
# ---------------------------------------------------------------------------
#
# JAX's threefry keys cannot be reproduced in PyTorch, so the port keeps
# the reference's laws and not its bits.  A request's noise is a pure
# function of (its seed, the index of the token being drawn, the vocabulary
# entry): a counter-based integer hash in torch ops.  The n-th token of a
# request therefore depends on (seed, params, context, n) alone, whatever
# runs beside it; nothing is carried between steps, so a speculative step
# that rejects a draft or an int8 step that emits nothing has no generator
# state to roll back.  A key is int64 ``[..., 2]``: (the request's 32-bit
# noise key, the index of the next token it draws).

_MASK32 = 0xFFFFFFFF
#: noise streams: the Gumbel draws of every sampled token, and the
#: uniforms of the speculative accept test
_GUMBEL, _ACCEPT = 0, 1
_STREAM_SALT = (0x3C6EF372, 0xA54FF53A)
_GOLDEN32 = 0x9E3779B9


def _mul32(x, c):
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) (a Python int or an int64
    tensor), without leaving int64: ``c`` is split into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A bijective 32-bit integer hash (Wellons' lowbias32) of ``x`` in
    [0, 2**32), a Python int or an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sampling_key(seed, row=0):
    """The 32-bit noise key of ``seed`` (any Python int); ``row`` tells the
    rows of one dense :func:`generate` batch apart (the engine's requests
    use row 0)."""
    seed %= 2 ** 64
    lo, hi = seed & _MASK32, seed >> 32
    return _mix32(_mix32(lo ^ _mix32(hi ^ _GOLDEN32)) ^ _mix32(row))


def _uniforms(keys, width, stream):
    """Uniforms in (0, 1), fp32 ``[..., width]``, for int64 keys
    ``[..., 2]``: entry ``v`` of a row is a pure function of (the row's
    key, its token index, ``v``, ``stream``)."""
    base = _mix32(_mix32(keys[..., 0] ^ _STREAM_SALT[stream])
                  ^ (keys[..., 1] & _MASK32))
    v = torch.arange(width, dtype=torch.int64, device=keys.device)
    bits = _mix32(base[..., None] ^ _mul32(v, _GOLDEN32))
    return ((bits >> 8).float() + 0.5) * 2.0 ** -24


def _gumbel(keys, width):
    """Standard Gumbel noise, fp32 ``[..., width]``, for int64 keys
    ``[..., 2]``: ``argmax(logits + noise)`` samples ``softmax(logits)``
    (the rule ``jax.random.categorical`` draws by)."""
    return -torch.log(-torch.log(_uniforms(keys, width, _GUMBEL)))


def _neg_fill(x):
    return torch.full_like(x, _NEG_INF)


def _filter_logits(logits, top_k, top_p):
    """Top-k and nucleus filtering with one ``top_k`` and ``top_p`` for
    every row (0 disables either).  Callers pass temperature-scaled logits,
    so the nucleus is the ``top_p`` mass of the distribution sampled."""
    if top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _neg_fill(logits), logits)
    if top_p:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest set whose mass reaches top_p: keep each entry whose
        # mass BEFORE it is below top_p
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, math.inf)
                             ).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, _neg_fill(logits), logits)
    return logits


def _filter_logits_per_slot(logits, top_k, top_p):
    """Top-k and nucleus filtering of ``logits [S, V]`` with per-row
    ``top_k`` (int ``[S]``) and ``top_p`` (fp32 ``[S]``); 0 disables either
    for its row.  One sort serves both filters: the k-filtered row sorted
    is the sorted row with the entries below its k-th largest set to
    -1e30."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = (top_k.long() - 1).clamp(0, v - 1)
    kth = sorted_desc.gather(-1, idx[:, None])
    use_k = (top_k > 0)[:, None]
    logits = torch.where(use_k & (logits < kth), _neg_fill(logits), logits)
    sorted_desc = torch.where(use_k & (sorted_desc < kth),
                              _neg_fill(sorted_desc), sorted_desc)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    cutoff = torch.where(keep, sorted_desc,
                         torch.full_like(sorted_desc, math.inf)
                         ).amin(-1, keepdim=True)
    return torch.where((top_p > 0)[:, None] & (logits < cutoff),
                       _neg_fill(logits), logits)


def _advance(keys, n):
    """``keys`` with each token index moved on by ``n`` (int or ``[...]``)."""
    step = torch.zeros_like(keys)
    step[..., 1] = n
    return keys + step


def sample_tokens(logits, temps, top_ks, top_ps, keys, noise=None):
    """One token per slot from ``logits [S, V]`` under per-slot sampling
    parameters: ``temps`` fp32 ``[S]`` (<= 0 is greedy argmax, bit-identical
    to the sampling-free path), ``top_ks`` int ``[S]``, ``top_ps`` fp32
    ``[S]`` (0 disables), ``keys`` int64 ``[S, 2]``.  ``noise``: Gumbel
    noise ``[S, V]`` to use instead of the keys' (tests inject the
    reference's).  Returns ``(tokens [S], new_keys [S, 2])``: a sampled
    slot's token index moves on by one."""
    greedy = logits.argmax(-1)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    filtered = _filter_logits_per_slot(scaled, top_ks, top_ps)
    if noise is None:
        noise = _gumbel(keys, logits.shape[-1])
    sampled = (filtered + noise).argmax(-1)
    hot = temps > 0
    return torch.where(hot, sampled, greedy), _advance(keys, hot.long())


# ---------------------------------------------------------------------------
# dense generation with a KV cache (the cache-free oracle's fast twin)
# ---------------------------------------------------------------------------

def _decode_one(p, tok, pos, caches, n_heads):
    """One dense decode step: ``tok`` int ``[B]`` at position ``pos``;
    ``caches`` per-layer ``(k, v)`` ``[B, K_kv, T_max, D]``, written in
    place at ``pos``.  Returns ``(logits [B, V], caches)``."""
    x = p["wte"][tok][:, None] + p["wpe"][pos]          # [B, 1, C]
    b, _, c = x.shape
    t_max = caches[0][0].shape[2]
    # keys past pos are zeros in the cache; mask them
    mask = (torch.arange(t_max, device=x.device) <= pos)[None, None, None]
    for lp, (kc, vc) in zip(p["layers"], caches):
        q, k, v = _block_qkv_kv(lp, x, n_heads)        # q [B, H, 1, D]
        kc[:, :, pos] = k[:, :, 0]
        vc[:, :, pos] = v[:, :, 0]
        o = _causal_attention(q, _bcast_kv(kc, n_heads),
                              _bcast_kv(vc, n_heads), mask)
        x = _block_finish(lp, x, o.transpose(1, 2).reshape(b, 1, c))
    return _ln(x[:, 0], p["lnf_g"], p["lnf_b"]) @ p["wte"].t(), caches


def _decode_runner(n_heads, greedy, n_new, t0, t_max, top_k=0, top_p=0.0):
    """The prefill + decode loop for one configuration: the prompt goes
    through ONE batched causal pass (:func:`_prefill`, which fills every
    cache and gives the first new token's logits); the ``n_new - 1``
    later tokens each take one :func:`_decode_one`.  Returns
    ``run(p, prompt [B, T0], keys [B, 2], temp) -> tokens [n_new, B]``."""
    def pick(logits, keys, temp):
        if greedy:
            return logits.argmax(-1), keys
        scaled = _filter_logits(logits / temp, top_k, top_p)
        return ((scaled + _gumbel(keys, scaled.shape[-1])).argmax(-1),
                _advance(keys, 1))

    def run(p, prompt, keys, temp):
        logits, caches = _prefill(p, prompt, t_max, n_heads)
        tok, keys = pick(logits, keys, temp)
        out = [tok]
        for pos in range(t0, t0 + n_new - 1):
            logits, caches = _decode_one(p, tok, pos, caches, n_heads)
            tok, keys = pick(logits, keys, temp)
            out.append(tok)
        return torch.stack(out)

    return run


def generate(net, prompt_ids, n_new, temperature=0.0, seed=0, top_k=0,
             top_p=0.0):
    """Autoregressive generation with a KV cache, on the device the net's
    weights live on: one batched prefill over the prompt, then one decode
    step a token.

    ``prompt_ids``: int array ``[B, T0]``; returns an int32 numpy array
    ``[B, T0 + n_new]``.  Temperature 0 is greedy; otherwise tokens are
    sampled with noise keyed by ``seed`` (deterministic per seed), filtered
    to the ``top_k`` highest logits and/or the ``top_p`` nucleus."""
    prompt_np = np.asarray(prompt_ids, np.int32)
    bsz, t0 = prompt_np.shape
    t_max = net._max_len
    if n_new < 1:
        raise ValueError("n_new must be >= 1, got %d" % n_new)
    if t0 + n_new > t_max:
        raise ValueError("prompt %d + new %d exceeds max_len %d"
                         % (t0, n_new, t_max))
    p = _decode_params(net)
    dev = p["wte"].device
    greedy = temperature <= 0
    run = _decode_runner(net.num_heads, greedy, n_new, t0, t_max,
                         0 if greedy else int(top_k),
                         0.0 if greedy else float(top_p))
    keys = torch.tensor([[sampling_key(seed, row), 0] for row in range(bsz)],
                        dtype=torch.int64, device=dev)
    with torch.no_grad():
        toks = run(p, torch.from_numpy(prompt_np).long().to(dev), keys,
                   max(float(temperature), 1e-6))
    return np.concatenate([prompt_np, toks.t().cpu().numpy()
                           .astype(np.int32)], axis=1)


# ---------------------------------------------------------------------------
# int8 page pools
# ---------------------------------------------------------------------------

_KV_QMAX = 127.0


def _kv_quantized(kv_pages):
    """A per-layer entry is ``(k, v)`` for full-precision pools or
    ``(k, v, k_scales, v_scales)`` for int8 pools with fp32
    ``[num_pages, K_kv]`` absmax scales."""
    return len(kv_pages[0]) == 4


def _quant_scatter(pool, scales, phys, offs, rows, mask):
    """Scatter K or V rows into an int8 page pool under per-page, per-KV-
    head absmax scales, IN PLACE.

    ``phys``/``offs``: int ``[R]`` physical page and in-page offset per
    row; ``rows``: fp32 ``[R, K_kv, D]``; ``mask``: bool ``[R]`` (False
    rows go to scratch page 0, as in the full-precision scatter).  The
    scale law of the JAX package:

    - a page receiving a row at offset 0 is fresh (its payload and scale
      are left over from the page's last owner): its scale resets to 0;
    - a page's scale only grows while it is written,
      ``s_new = max(s_old, rowmax / 127)``, and the page's existing
      payload is re-expressed under the grown scale
      (``round(int8 * s_old / s_new)``: exact when the scale did not grow);
    - new rows quantize under the page's final scale, so the order of the
      rows within one call does not matter.

    Returns ``(pool, scales)``.
    """
    phys, offs = phys.long(), offs.long()
    rows = rows * mask[:, None, None]
    zero = torch.zeros_like(phys)
    tgt = torch.where(mask, phys, zero)
    fresh_tgt = torch.where(mask & (offs == 0), phys, zero)
    rowmax = rows.abs().amax(-1)                       # [R, K_kv]
    scales[fresh_tgt] = 0.0
    s_pre = scales[tgt]                                # [R, K_kv]
    scales.scatter_reduce_(0, tgt[:, None].expand_as(rowmax),
                           rowmax / _KV_QMAX, reduce="amax")
    s_post = scales[tgt]
    # Rows landing in one page carry the same s_pre and s_post and read
    # the same old payload, so duplicate indices below write identical
    # values: the scatter is deterministic on CUDA too.  Masked rows all
    # land on scratch page 0 as zeros.
    ratio = torch.where(s_post > 0, s_pre / s_post, torch.zeros_like(s_post))
    old = pool[tgt].float()                            # [R, page, K_kv, D]
    pool[tgt] = torch.clamp(torch.round(old * ratio[:, None, :, None]),
                            -_KV_QMAX, _KV_QMAX).to(pool.dtype)
    q = torch.clamp(
        torch.round(rows / torch.clamp(s_post, min=1e-30)[:, :, None]),
        -_KV_QMAX, _KV_QMAX)
    pool[tgt, offs] = q.to(pool.dtype)
    return pool, scales


def _scatter_kv(entry, phys, offs, k_rows, v_rows, mask):
    """Write one layer's K/V rows ``[R, K_kv, D]`` into its pools in
    place: int8 pools through :func:`_quant_scatter`, float pools by a
    plain index write (masked rows already point at scratch page 0).
    Returns the scale pools as attention keyword arguments."""
    if len(entry) == 4:
        kc, vc, ks, vs = entry
        _quant_scatter(kc, ks, phys, offs, k_rows, mask)
        _quant_scatter(vc, vs, phys, offs, v_rows, mask)
        return {"k_scales": ks, "v_scales": vs}
    kc, vc = entry
    # masked rows all write scratch page 0, in no fixed order on CUDA;
    # harmless, because page 0 is never read at an in-range position
    kc[phys, offs] = k_rows.to(kc.dtype)
    vc[phys, offs] = v_rows.to(vc.dtype)
    return {}


# ---------------------------------------------------------------------------
# serving programs
# ---------------------------------------------------------------------------
#
# ``sampling`` is None (greedy argmax: the programs return 3-tuples, or
# 4-tuples for the spec step) or per-slot ``(temps [S], top_ks [S],
# top_ps [S], keys [S, 2])`` tensors on the params' device (scalars and
# ``keys [2]`` for a prefill's one request); then the advanced keys come
# back before the pages.

def _first_token(logits, sampling, new_pages, noise=None):
    """The prefill tail: ``(logits, argmax token, pages)``, or with
    ``sampling`` the request's first token drawn by :func:`sample_tokens`
    and ``(logits, token, new_key, pages)``.  ``noise``: Gumbel noise
    ``[V]`` to use instead of the key's."""
    if sampling is None:
        return logits, logits.argmax(-1), new_pages
    temp, top_k, top_p, key = (torch.as_tensor(a, device=logits.device)
                               for a in sampling)
    tok, new_key = sample_tokens(
        logits[None], temp.reshape(1).float(), top_k.reshape(1),
        top_p.reshape(1).float(), key.reshape(1, 2).long(),
        None if noise is None else noise.reshape(1, -1))
    return logits, tok[0], new_key[0], new_pages


def paged_prefill(p, tokens, prompt_len, block_table_row, kv_pages,
                  n_heads, sampling=None):
    """Admit one request: a dense causal pass over its prompt that
    scatters every position's K/V into the slot's pages and returns the
    last prompt position's logits and first token.

    - ``tokens``: int ``[T_pad]`` on the params' device, the prompt
      (optionally padded; positions ``>= prompt_len`` are masked out of
      attention and their K/V goes to scratch page 0);
    - ``prompt_len``: int;
    - ``block_table_row``: int ``[max_pages_per_seq]`` for this slot;
    - ``kv_pages``: list of per-layer ``(k_pages, v_pages)``, each
      ``[num_pages, page_size, K_kv, D]`` float32 or bfloat16, or
      ``(k_pages, v_pages, k_scales, v_scales)`` with int8 pools, updated
      in place;
    - ``sampling``: None or the request's scalar sampling parameters.

    Returns ``(logits [V] fp32, first_token, kv_pages)`` (with the
    advanced key before ``kv_pages`` when sampling).
    """
    t_pad = tokens.shape[0]
    page_size = kv_pages[0][0].shape[1]
    dev = tokens.device
    x = (p["wte"][tokens] + p["wpe"][:t_pad])[None]    # [1, T_pad, C]
    c = x.shape[-1]
    pos = torch.arange(t_pad, device=dev)
    valid = pos < prompt_len
    mask = (torch.ones(t_pad, t_pad, dtype=torch.bool, device=dev).tril()
            & valid[None, :])[None, None]
    bt = block_table_row.long()
    phys = torch.where(valid, bt[pos // page_size], torch.zeros_like(pos))
    offs = pos % page_size
    for lp, entry in zip(p["layers"], kv_pages):
        q, k, v = _block_qkv_kv(lp, x, n_heads)   # [1, H|K_kv, T_pad, D]
        o = _causal_attention(q, _bcast_kv(k, n_heads),
                              _bcast_kv(v, n_heads), mask)
        _scatter_kv(entry, phys, offs, k[0].transpose(0, 1),
                    v[0].transpose(0, 1), valid)
        x = _block_finish(lp, x, o.transpose(1, 2).reshape(1, t_pad, c))
    last = _ln(x[0, prompt_len - 1], p["lnf_g"], p["lnf_b"])
    return _first_token(last @ p["wte"].t(), sampling, kv_pages)


def paged_suffix_prefill(p, tokens, prompt_len, prefix_len,
                         block_table_row, cow_src, cow_dst, kv_pages,
                         n_heads, sampling=None):
    """Admit one request whose first ``prefix_len`` prompt tokens already
    have their K/V in the pages ``block_table_row`` maps (shared full
    pages and, optionally, one copy-on-write page): prefill only the rest.

    - ``tokens``: int ``[T_pad]``, the SUFFIX ``prompt[prefix_len:]``
      (optionally padded); suffix position ``i`` is absolute position
      ``prefix_len + i``;
    - ``prompt_len``, ``prefix_len``: ints, ``0 < prefix_len <
      prompt_len``;
    - ``cow_src``, ``cow_dst``: physical page ids (ints).  Each layer first
      copies page ``cow_src`` to ``cow_dst``, with its scale rows for int8
      pools: the copy-on-write of a prefix that ends mid-page, after
      which this request's suffix overwrites the copy's tail and the donor
      stays as it was.  Equal ids (scratch for both) mean no copy;
    - suffix queries attend over the cached prefix, gathered through the
      block table (dequantized for int8) and masked at ``prefix_len``,
      and over the causal window of the suffix, in one softmax.

    Returns like :func:`paged_prefill`; the logits are the LAST prompt
    position's, so the first generated token comes from here.
    """
    t_pad = tokens.shape[0]
    page_size = kv_pages[0][0].shape[1]
    dev = tokens.device
    bt = block_table_row.long()
    mp = bt.shape[0]
    t_ctx = mp * page_size
    suffix_len = prompt_len - prefix_len
    positions = prefix_len + torch.arange(t_pad, device=dev)
    # pad positions may run past the position table and the block table;
    # they are masked, so any in-range row serves
    x = (p["wte"][tokens]
         + p["wpe"][positions.clamp(max=p["wpe"].shape[0] - 1)])[None]
    c = x.shape[-1]
    d = c // n_heads
    i = torch.arange(t_pad, device=dev)
    valid = i < suffix_len
    # suffix against suffix: causal, pads masked
    mask_suf = (torch.ones(t_pad, t_pad, dtype=torch.bool, device=dev).tril()
                & valid[None, :])[None, None]
    # suffix against the cached prefix: every suffix query sees every key
    pre_valid = torch.arange(t_ctx, device=dev) < prefix_len
    mask_pre = pre_valid[None, None, None, :]
    phys = torch.where(valid, bt[(positions // page_size).clamp(max=mp - 1)],
                       torch.zeros_like(positions))
    offs = positions % page_size
    for lp, entry in zip(p["layers"], kv_pages):
        kc, vc = entry[0], entry[1]
        # copy-on-write first: the gather below must see the copy
        if cow_src != cow_dst:
            for pool in entry:
                pool[cow_dst] = pool[cow_src]
        if len(entry) == 4:
            ks, vs = entry[2], entry[3]
            kg = kc[bt].float() * ks[bt][:, None, :, None]
            vg = vc[bt].float() * vs[bt][:, None, :, None]
        else:
            kg, vg = kc[bt].float(), vc[bt].float()
        q, k, v = _block_qkv_kv(lp, x, n_heads)
        kd, vd = _bcast_kv(k, n_heads), _bcast_kv(v, n_heads)
        # the cached prefix: [mp, page, K_kv, D] -> [1, H, t_ctx, D]
        kp = _bcast_kv(kg.reshape(t_ctx, -1, d).transpose(0, 1)[None],
                       n_heads)
        vp = _bcast_kv(vg.reshape(t_ctx, -1, d).transpose(0, 1)[None],
                       n_heads)
        # rows past the prefix come from scratch or unwritten pages, whose
        # contents may be anything: a NaN there (the scratch writes of a
        # hot-swap canary on torn weights) would reach the output through
        # 0 * NaN although its weight is 0, so zero the V rows too
        vp = torch.where(pre_valid[None, None, :, None], vp,
                         torch.zeros_like(vp))
        scale = math.sqrt(d)
        st_pre = torch.where(
            mask_pre, torch.einsum("bhqd,bhkd->bhqk", q, kp) / scale,
            torch.full((), _NEG_INF, device=dev))
        st_suf = torch.where(
            mask_suf, torch.einsum("bhqd,bhkd->bhqk", q, kd) / scale,
            torch.full((), _NEG_INF, device=dev))
        pr = torch.softmax(torch.cat([st_pre, st_suf], dim=-1), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", pr, torch.cat([vp, vd], dim=2))
        # the copy-on-write page is the only written page with content;
        # the int8 scatter's grow-only rescale keeps that content
        _scatter_kv(entry, phys, offs, k[0].transpose(0, 1),
                    v[0].transpose(0, 1), valid)
        x = _block_finish(lp, x, o.transpose(1, 2).reshape(1, t_pad, c))
    last = _ln(x[0, suffix_len - 1], p["lnf_g"], p["lnf_b"])
    return _first_token(last @ p["wte"].t(), sampling, kv_pages)


def paged_decode_step(p, tokens, positions, active, kv_pages,
                      block_tables, n_heads, sampling=None):
    """ONE decode step for every serving slot: each layer scatters the
    step's K/V into the pages and launches the paged-attention kernel
    once, so a step is ``n_layers`` kernel launches.

    - ``tokens``: int ``[S]``, each slot's current token (ignored where
      inactive);
    - ``positions``: int ``[S]``, the position this token occupies (the
      slot's context length before this step);
    - ``active``: bool ``[S]``, slot occupancy.  Inactive slots write
      their K/V to scratch page 0 and attend over nothing, so occupancy
      never changes a resident slot's math;
    - ``kv_pages``: list of per-layer pool entries (see
      :func:`paged_prefill`), updated in place;
    - ``block_tables``: int32 ``[S, max_pages_per_seq]``, contiguous;
    - ``sampling``: None or the per-slot sampling tensors.

    Returns ``(logits [S, V] fp32, next_tokens [S], kv_pages)``, or
    ``(logits, next_tokens, new_keys, kv_pages)`` with ``sampling``.
    """
    s_n = tokens.shape[0]
    page_size = kv_pages[0][0].shape[1]
    x = p["wte"][tokens][:, None] + p["wpe"][positions][:, None]
    c = x.shape[-1]
    positions = positions.long()
    # where each slot's new K/V lands; inactive slots go to scratch page 0
    logical = positions // page_size
    phys = torch.where(active, block_tables.long().gather(
        1, logical[:, None])[:, 0], torch.zeros_like(logical))
    offs = positions % page_size
    # the step's own token is key position `positions`: inclusive ctx
    ctx = torch.where(active, positions + 1,
                      torch.zeros_like(positions)).to(torch.int32)
    for lp, entry in zip(p["layers"], kv_pages):
        q, k, v = _block_qkv_kv(lp, x, n_heads)     # q [S, H, 1, D]
        scales = _scatter_kv(entry, phys, offs, k[:, :, 0, :],
                             v[:, :, 0, :], active)
        o = paged_attention(q[:, :, 0, :].contiguous(), entry[0], entry[1],
                            block_tables, ctx, **scales)
        x = _block_finish(lp, x, o.reshape(s_n, 1, c))
    logits = _ln(x[:, 0], p["lnf_g"], p["lnf_b"]) @ p["wte"].t()
    if sampling is None:
        return logits, logits.argmax(-1), kv_pages
    nxt, new_keys = sample_tokens(logits, *sampling)
    return logits, nxt, new_keys, kv_pages


def _spec_accept_greedy(logits, tokens, draft_valid):
    """Greedy prefix acceptance of one verify pass: ``greedy_next[s, i]``
    is the argmax after query position ``i``; draft ``tokens[s, i + 1]``
    is accepted iff every earlier draft was and it equals
    ``greedy_next[s, i]``.  The emitted run is ``greedy_next[s, :n_new]``
    (position ``accepted`` is the free correction or bonus token), so any
    draft, even garbage, yields the exact greedy stream.  Returns
    ``(greedy_next [S, K], accepted [S])``."""
    greedy_next = logits.argmax(-1)                     # [S, K]
    match = (greedy_next[:, :-1] == tokens[:, 1:]) & draft_valid
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    return greedy_next, accepted


def _spec_sample(logits, tokens, draft_valid, temps, top_ks, top_ps, keys,
                 noise=None):
    """Rejection-sampling verification of the draft tokens of sampled
    slots.  The drafter is deterministic (it proposes draft ``d`` with
    probability 1), so the accept test is ``u < p_i[d]`` against the
    slot's filtered, temperature-scaled distribution at position ``i``;
    on rejection the token is drawn from ``p_i`` with ``d`` masked out, and
    the bonus position (no draft after it) draws from ``p_i`` directly.
    Position ``i`` draws the noise of token index ``keys[s, 1] + i``, so
    the chain moves on by one step per EMITTED token.

    ``noise``: ``(u [S, K - 1], gumbel [S, K, V])`` to use instead of the
    keys' (tests inject the reference's).  Returns ``(emitted [S, K],
    accepted [S], keys_after [K, S, 2])``, ``keys_after[i]`` the keys after
    ``i + 1`` emitted tokens."""
    s_n, k1, v = logits.shape
    scaled = logits / temps.clamp(min=1e-6)[:, None, None]
    filtered = _filter_logits_per_slot(
        scaled.reshape(s_n * k1, v), top_ks.repeat_interleave(k1),
        top_ps.repeat_interleave(k1)).reshape(s_n, k1, v)
    pos_keys = _advance(keys[:, None].expand(s_n, k1, 2),
                        torch.arange(k1, device=keys.device))
    if noise is None:
        u = _uniforms(pos_keys[:, :-1], 1, _ACCEPT)[..., 0]
        g = _gumbel(pos_keys, v)
    else:
        u, g = noise
    drafts = tokens[:, 1:].long()                       # [S, K - 1]
    head = filtered[:, :-1]
    p_d = torch.softmax(head, dim=-1).gather(-1, drafts[..., None])[..., 0]
    accept = (u < p_d) & draft_valid
    direct = (filtered + g).argmax(-1)                  # [S, K]
    masked = head.scatter(-1, drafts[..., None], _NEG_INF)
    resample = (masked + g[:, :-1]).argmax(-1)
    emit = torch.cat([torch.where(draft_valid,
                                  torch.where(accept, drafts, resample),
                                  direct[:, :-1]), direct[:, -1:]], dim=1)
    cont = torch.cat([accept, torch.zeros_like(accept[:, :1])], dim=1)
    accepted = torch.cumprod(cont.long(), dim=1).sum(dim=1)
    return emit, accepted, _advance(pos_keys, 1).transpose(0, 1)


def paged_spec_decode_step(p, tokens, positions, active, draft_len,
                           kv_pages, block_tables, n_heads, sampling=None):
    """ONE speculative decode step for every serving slot: the slot's
    last emitted token plus up to ``K - 1`` draft tokens go through the
    model together, and the longest verified prefix plus the free
    correction or bonus token is emitted: up to ``K`` tokens per slot from
    one call, in which each layer launches the multi-position paged
    kernel once (occupancy and draft length are masks, not shapes).

    - ``tokens``: int ``[S, K]``; ``tokens[s, 0]`` is the slot's current
      token, ``tokens[s, 1:]`` its drafts (ignored past ``draft_len[s]``);
    - ``positions``: int ``[S, K]``, consecutive positions starting at the
      position of ``tokens[s, 0]``;
    - ``active``: bool ``[S]``; ``draft_len``: int ``[S]`` in
      ``[0, K - 1]`` (0 is the plain one-token step);
    - ``kv_pages``, ``block_tables``: as in :func:`paged_decode_step`;
    - ``sampling``: None (greedy acceptance) or the per-slot sampling
      tensors: sampled slots verify by :func:`_spec_sample`.

    Every real query row's K/V is written into the slot's pages before
    attention (other rows go to scratch page 0); query ``i`` attends
    through its own position.  Rejected draft positions need no rollback:
    they lie past the slot's committed context, every later step masks
    them, and later tokens overwrite them in place.

    Returns ``(logits [S, K, V] fp32, out_tokens [S, K], n_new [S],
    kv_pages)``, with ``sampling`` ``(logits, out_tokens, n_new, new_keys,
    kv_pages)``; slot ``s`` emits ``out_tokens[s, :n_new[s]]``.
    """
    s_n, k1 = tokens.shape
    page_size = kv_pages[0][0].shape[1]
    positions = positions.long()
    qpos = torch.arange(k1, device=tokens.device)
    # a row is real when the slot is live and it is the current token
    # (i == 0) or a draft (i <= draft_len)
    qmask = active[:, None] & (qpos[None, :] <= draft_len[:, None])
    x = p["wte"][tokens] + p["wpe"][positions]          # [S, K, C]
    c = x.shape[-1]
    phys = torch.where(qmask, block_tables.long().gather(
        1, positions // page_size), torch.zeros_like(positions))
    offs = positions % page_size
    ctx = torch.where(qmask, positions + 1,
                      torch.zeros_like(positions)).to(torch.int32)
    for lp, entry in zip(p["layers"], kv_pages):
        q, k, v = _block_qkv_kv(lp, x, n_heads)   # q [S, H, K, D]
        kr = k.transpose(1, 2).reshape((s_n * k1,) + k.shape[1:2]
                                       + k.shape[3:])
        vr = v.transpose(1, 2).reshape(kr.shape)
        scales = _scatter_kv(entry, phys.reshape(-1), offs.reshape(-1), kr,
                             vr, qmask.reshape(-1))
        o = paged_attention_multi(q.transpose(1, 2).contiguous(), entry[0],
                                  entry[1], block_tables, ctx, **scales)
        x = _block_finish(lp, x, o.reshape(s_n, k1, c))
    logits = _ln(x, p["lnf_g"], p["lnf_b"]) @ p["wte"].t()   # [S, K, V]
    draft_valid = qmask[:, 1:]
    greedy_next, accepted = _spec_accept_greedy(logits, tokens, draft_valid)
    n_new = torch.where(active, accepted + 1, torch.zeros_like(accepted))
    if sampling is None:
        return logits, greedy_next, n_new, kv_pages
    temps, top_ks, top_ps, keys = sampling
    emit, acc_s, keys_after = _spec_sample(logits, tokens, draft_valid,
                                           temps, top_ks, top_ps, keys)
    hot = temps > 0
    out = torch.where(hot[:, None], emit, greedy_next)
    n_new = torch.where(hot & active, acc_s + 1, n_new)
    # the keys after the last emitted token; greedy or idle slots keep
    # theirs
    sel = keys_after.transpose(0, 1).gather(
        1, (n_new - 1).clamp(0, k1 - 1)[:, None, None].expand(s_n, 1, 2)
    )[:, 0]
    new_keys = torch.where((hot & active)[:, None], sel, keys)
    return logits, out, n_new, new_keys, kv_pages
