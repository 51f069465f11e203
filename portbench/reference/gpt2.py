"""GPT-2 in plain PyTorch: the yardstick the port is held against.

This file follows the published GPT-2 (pre-LN blocks, learned position
embeddings, gelu with the tanh approximation, a head tied to the token
embedding) and imports nothing of the program under test.  Whatever the
program derives from the configuration, it works out here again: the
vocabulary padded to a multiple of 128, the positions of packed
documents, the head-major order of the fused q/k/v rows, the Adam update.

Weights are a flat dict of float32 tensors under the names of
:func:`param_shapes`.  ``precision`` selects how every matrix product is
computed:

- ``"fp32"``: float32 with TF32 off (the configuration's precision);
- ``"tf32"``: float32 inputs on the tensor cores in TF32 (the control of a
  float32 cell);
- ``"fp8"``: both operands of every product rounded to float8 e4m3 under
  a per-tensor scale, then multiplied in float32 (the control of a
  bfloat16 cell).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
FP8_MAX = 448.0


def pad_vocab(vocab, mult=128):
    """The vocabulary rounded up to a multiple of ``mult``."""
    return (vocab + mult - 1) // mult * mult


def param_shapes(cfg):
    """``{name: shape}`` of every weight, in the order weights are drawn."""
    c, v = cfg["n_embd"], pad_vocab(cfg["vocab_size"])
    shapes = {"wte": (v, c), "wpe": (cfg["n_ctx"], c)}
    for i in range(cfg["n_layer"]):
        p = "h.%d." % i
        shapes.update({
            p + "ln1.g": (c,), p + "ln1.b": (c,),
            p + "qkv.w": (3 * c, c), p + "qkv.b": (3 * c,),
            p + "out.w": (c, c), p + "out.b": (c,),
            p + "ln2.g": (c,), p + "ln2.b": (c,),
            p + "fc1.w": (4 * c, c), p + "fc1.b": (4 * c,),
            p + "fc2.w": (c, 4 * c), p + "fc2.b": (c,)})
    shapes.update({"lnf.g": (c,), "lnf.b": (c,)})
    return shapes


@contextlib.contextmanager
def matmul_precision(precision):
    """TF32 on for ``"tf32"``, off otherwise; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def _mm(a, b, precision):
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return torch.matmul(a, b)


def _linear(x, w, b, precision):
    return _mm(x, w.t(), precision) + b


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, LN_EPS)


def positions(segments, t, device):
    """Position ids ``[B, T]``: ``0..T-1``, or restarting at every change
    of segment id along a packed row."""
    idx = torch.arange(t, device=device)
    if segments is None:
        return idx[None]
    seg = segments.long()
    new = torch.ones_like(seg, dtype=torch.bool)
    new[:, 1:] = seg[:, 1:] != seg[:, :-1]
    # each position minus the start of the run of equal ids it lies in
    start = torch.where(new, idx[None], torch.zeros_like(seg))
    return idx[None] - torch.cummax(start, dim=1).values


def visible(segments, t, device):
    """bool ``[B or 1, 1, T, T]``: query i sees key j when j <= i and, in
    a packed row, both carry the same segment id."""
    causal = torch.ones(t, t, dtype=torch.bool, device=device).tril()
    if segments is None:
        return causal[None, None]
    same = segments[:, :, None] == segments[:, None, :]
    return (causal[None] & same)[:, None]


def forward(w, cfg, tokens, segments=None, precision="fp32", pos=None):
    """Logits ``[B, T, V_padded]`` of ``tokens`` ``[B, T]``."""
    b, t = tokens.shape
    c, h = cfg["n_embd"], cfg["n_head"]
    d = c // h
    dev = tokens.device
    if pos is None:
        pos = positions(segments, t, dev)
    x = w["wte"][tokens] + w["wpe"][pos]
    mask = visible(segments, t, dev)
    for i in range(cfg["n_layer"]):
        p = "h.%d." % i
        a = _ln(x, w[p + "ln1.g"], w[p + "ln1.b"])
        # the fused projection's rows are head-major: [H, (q, k, v), D]
        qkv = _linear(a, w[p + "qkv.w"], w[p + "qkv.b"], precision)
        qkv = qkv.reshape(b, t, h, 3, d).permute(3, 0, 2, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(d)
        s = s.masked_fill(~mask, float("-inf"))
        o = _mm(torch.softmax(s, dim=-1), v, precision)
        o = o.transpose(1, 2).reshape(b, t, c)
        x = x + _linear(o, w[p + "out.w"], w[p + "out.b"], precision)
        a = _ln(x, w[p + "ln2.g"], w[p + "ln2.b"])
        a = F.gelu(_linear(a, w[p + "fc1.w"], w[p + "fc1.b"], precision),
                   approximate="tanh")
        x = x + _linear(a, w[p + "fc2.w"], w[p + "fc2.b"], precision)
    x = _ln(x, w["lnf.g"], w["lnf.b"])
    return _mm(x, w["wte"].t(), precision)


def token_logits(w, cfg, tokens, precision="fp32"):
    """Full-context logits ``[T, V_padded]`` of one sequence ``[T]``: row
    ``i`` scores the token after position ``i``."""
    with torch.no_grad(), matmul_precision(precision):
        return forward(w, cfg, tokens[None], precision=precision)[0]


class Adam:
    """Adam with the bias correction folded into the step size, as MXNet
    defines it: ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``,
    ``w -= lr_t * m / (sqrt(v) + eps)``; the gradient is first multiplied
    by ``rescale``.  No weight decay."""

    def __init__(self, params, lr, beta1, beta2, eps, rescale):
        self.params = params
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps
        self.rescale = rescale
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self):
        self.t += 1
        lr_t = (self.lr * math.sqrt(1.0 - self.beta2 ** self.t)
                / (1.0 - self.beta1 ** self.t))
        for n, p in self.params.items():
            g = p.grad * self.rescale
            self.m[n].mul_(self.beta1).add_(g, alpha=1.0 - self.beta1)
            self.v[n].mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            p.sub_(lr_t * self.m[n] / (self.v[n].sqrt() + self.eps))


def train(w, cfg, batches, opt_cfg, precision="fp32", rows_per_pass=4,
          rows=None):
    """Train a copy of ``w`` for ``len(batches)`` steps of mean token
    cross-entropy over the padded vocabulary.

    ``batches``: ``(x, y, segments or None)`` with ``x``/``y`` ``[B, T]``.
    ``opt_cfg``: ``lr``, ``beta1``, ``beta2``, ``epsilon``; the gradient
    of the mean loss is scaled by ``1 / B`` before Adam, as the Gluon loop
    hands it over (``trainer.step(B)``).  The rows of a batch go through in
    passes of ``rows_per_pass`` whose gradients add up, so that a batch of
    any size fits.  ``rows``: use only the first ``rows`` rows of every
    batch (a fault the check must see).

    Returns ``{"losses": [...], "grad_norms": {name: float} (the first
    step's gradient as Adam gets it), "delta_norms": {name: float} (the
    change of every weight over all the steps)}``.
    """
    params = {n: t.detach().clone().requires_grad_(True) for n, t in w.items()}
    b = batches[0][0].shape[0] if rows is None else rows
    opt = Adam(params, opt_cfg["lr"], opt_cfg["beta1"], opt_cfg["beta2"],
               opt_cfg["epsilon"], 1.0 / b)
    losses, grad_norms = [], None
    with matmul_precision(precision):
        for step, (x, y, seg) in enumerate(batches):
            x, y = x[:b], y[:b]
            seg = None if seg is None else seg[:b]
            for p in params.values():
                p.grad = None
            n_tok = x.numel()
            total = 0.0
            for r in range(0, b, rows_per_pass):
                sl = slice(r, r + rows_per_pass)
                logits = forward(params, cfg, x[sl],
                                 None if seg is None else seg[sl],
                                 precision=precision)
                loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       y[sl].reshape(-1).long(),
                                       reduction="sum") / n_tok
                loss.backward()
                total += float(loss.detach())
                del logits, loss
            losses.append(total)
            if step == 0:
                grad_norms = {n: float((p.grad * opt.rescale).norm())
                              for n, p in params.items()}
            opt.step()
    delta = {n: float((params[n].detach() - w[n]).norm()) for n in w}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}
