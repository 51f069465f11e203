"""Where the benchmark meets the program under test (``mxnet_tpu_torch``).

Everything here is the program's public surface: the model zoo's GPT,
its parameters by attribute, the op registry's attention op and the
serving programs' module functions.  The ranges this file opens around
them are the benchmark's own spans: they name the host's work in the
profiler's timeline and tie every kernel to the call that launched it,
whatever kernel that is.
"""
from __future__ import annotations

import contextlib
import functools

import torch


def gpt_leaves(net):
    """``[(parameter, reference name)]`` of a model-zoo GPTLM."""
    out = [(net.wte, "wte"), (net.wpe, "wpe")]
    for i, blk in enumerate(net.blocks):
        p = "h.%d." % i
        out += [(blk.ln1.gamma, p + "ln1.g"), (blk.ln1.beta, p + "ln1.b"),
                (blk.attn.qkv.weight, p + "qkv.w"),
                (blk.attn.qkv.bias, p + "qkv.b"),
                (blk.attn.out_proj.weight, p + "out.w"),
                (blk.attn.out_proj.bias, p + "out.b"),
                (blk.ln2.gamma, p + "ln2.g"), (blk.ln2.beta, p + "ln2.b"),
                (blk.fc1.weight, p + "fc1.w"), (blk.fc1.bias, p + "fc1.b"),
                (blk.fc2.weight, p + "fc2.w"), (blk.fc2.bias, p + "fc2.b")]
    out += [(net.ln_f.gamma, "lnf.g"), (net.ln_f.beta, "lnf.b")]
    return out


def build_gpt(cfg, weights, device):
    """The zoo's GPT at ``cfg``'s sizes, holding ``weights`` on
    ``device``."""
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    net = gpt.get_gpt(cfg["n_layer"], cfg["n_embd"], cfg["n_head"],
                      vocab_size=cfg["vocab_size"], max_len=cfg["n_ctx"])
    leaves = gpt_leaves(net)
    if len(leaves) != len(net.collect_params()):
        raise RuntimeError("the model has %d parameters, the benchmark "
                           "knows %d" % (len(net.collect_params()),
                                         len(leaves)))
    for param, name in leaves:
        param.set_data(weights[name].to(device))
    return net


@contextlib.contextmanager
def ranged(obj, attr, label, on_call=None):
    """Replace ``obj.attr`` (a function) for the block's duration by one
    that runs it inside the profiler range ``label``; ``on_call(args,
    kwargs)`` sees every call first."""
    orig = getattr(obj, attr)

    @functools.wraps(orig)
    def wrapped(*args, **kwargs):
        if on_call is not None:
            on_call(args, kwargs)
        with torch.profiler.record_function(label):
            return orig(*args, **kwargs)

    setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def attention_op():
    """The registry's fused attention op, which every GPT block calls."""
    from mxnet_tpu_torch.ops import get_op
    return get_op("_contrib_flash_attention")
