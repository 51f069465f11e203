"""Neural-network operators (counterpart of part of
``mxnet_tpu/ops/nn.py``): ``FullyConnected``, ``Activation``,
``LeakyReLU``, ``softmax``, ``log_softmax``, ``SoftmaxOutput``,
``BatchNorm``, ``LayerNorm`` and ``Dropout``.

``BatchNorm`` returns its new moving statistics after its visible outputs
(``mutate_aux``); the caller writes them into the aux arrays, as the
reference's imperative invoke and CachedOp do.  ``Dropout`` draws its mask
from :mod:`mxnet_tpu_torch.random`'s generator of the data's device
(``needs_rng``: the port's ops take no key argument).

``SoftmaxOutput`` keeps MXNet's implicit-gradient contract through a
``torch.autograd.Function``: its forward is the softmax, and its backward
injects ``prob - one_hot(label)`` (with ``grad_scale``, ``use_ignore``,
``normalization`` and ``smooth_alpha``) whatever sits above it, ignoring
the head gradient unless ``out_grad`` is set; the label gets a zero
gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import alias, register_op


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

@register_op("FullyConnected",
             arg_names=lambda p: (["data", "weight"] if p.get("no_bias")
                                  else ["data", "weight", "bias"]),
             param_defaults={"num_hidden": 0, "no_bias": False,
                             "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):
    if flatten and data.dim() > 2:
        data = data.reshape((data.shape[0], -1))
    # one F.linear, the same call as _fused_dense_act: the two are
    # bit-identical on every device
    return F.linear(data, weight, bias)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

@register_op("Activation", arg_names=("data",),
             param_defaults={"act_type": "relu"})
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return F.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    if act_type == "gelu":
        # the tanh form (GPT-2's), as the reference's
        return F.gelu(data, approximate="tanh")
    if act_type == "gelu_erf":
        return F.gelu(data)
    raise ValueError("unknown act_type %s" % act_type)


@register_op("LeakyReLU",
             arg_names=lambda p: (["data", "gamma"]
                                  if p.get("act_type") == "prelu"
                                  else ["data"]),
             param_defaults={"act_type": "leaky", "slope": 0.25,
                             "lower_bound": 0.125, "upper_bound": 0.334})
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data > 0, data, g * data)
    if act_type == "rrelu":
        # the reference's deterministic midpoint slope
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, mid * data)
    raise ValueError("unknown act_type %s" % act_type)


# ---------------------------------------------------------------------------
# Softmax family
# ---------------------------------------------------------------------------

@register_op("softmax", arg_names=("data",),
             param_defaults={"axis": -1, "temperature": None})
def _softmax(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.softmax(data, dim=axis)


@register_op("log_softmax", arg_names=("data",),
             param_defaults={"axis": -1, "temperature": None})
def _log_softmax(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


def _softmax_output_prob(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape((data.shape[0], -1)),
                         dim=-1).reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward: the softmax.  Backward: the fused softmax + cross-entropy
    gradient of the reference's custom VJP."""

    @staticmethod
    def forward(ctx, data, label, p):
        prob = _softmax_output_prob(data, p["multi_output"],
                                    p["preserve_shape"])
        ctx.save_for_backward(prob, label)
        ctx.p = p
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        p = ctx.p
        axis = 1 if p["multi_output"] else -1
        nclass = prob.shape[axis]
        lbl = label.to(torch.int64)
        # jax.nn.one_hot: an id outside [0, nclass) (ignore_label -1) is an
        # all-zero row, where F.one_hot would raise
        onehot = (lbl[..., None] == torch.arange(
            nclass, device=lbl.device)).to(prob.dtype)
        alpha = p["smooth_alpha"]
        if alpha:
            onehot = onehot * (1.0 - alpha) + \
                alpha / (nclass - 1) * (1.0 - onehot)
        if p["multi_output"]:
            onehot = torch.movedim(onehot, -1, 1)
        grad = prob - onehot.reshape(prob.shape)
        valid = None
        if p["use_ignore"]:
            mask = lbl != int(p["ignore_label"])
            bmask = torch.unsqueeze(mask, axis).to(prob.dtype)
            grad = grad * bmask.expand(prob.shape)
            valid = torch.clamp_min(mask.to(prob.dtype).sum(), 1.0)
        if p["normalization"] == "batch":
            grad = grad / prob.shape[0]
        elif p["normalization"] == "valid" and valid is not None:
            grad = grad / valid
        grad = grad * p["grad_scale"]
        if p["out_grad"]:
            grad = grad * g
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad.to(prob.dtype), dlabel, None


@register_op("SoftmaxOutput", arg_names=("data", "label"),
             backward_ignore=("label",),
             param_defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                             "multi_output": False, "use_ignore": False,
                             "preserve_shape": False,
                             "normalization": "null",
                             "smooth_alpha": 0.0, "out_grad": False})
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    smooth_alpha=0.0, out_grad=False):
    p = {"grad_scale": grad_scale, "ignore_label": ignore_label,
         "multi_output": bool(multi_output), "use_ignore": bool(use_ignore),
         "preserve_shape": bool(preserve_shape),
         "normalization": normalization, "smooth_alpha": smooth_alpha,
         "out_grad": bool(out_grad)}
    return _SoftmaxOutput.apply(data, label, p)


alias("SoftmaxOutput", "Softmax")


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@register_op("LayerNorm", arg_names=("data", "gamma", "beta"),
             param_defaults={"axis": -1, "eps": 1e-5})
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over one axis, statistics in at least fp32 (the
    reference's recipe: two-pass mean and variance, ``rsqrt``)."""
    x = data.to(torch.promote_types(data.dtype, torch.float32))
    mean = x.mean(dim=axis, keepdim=True)
    var = torch.square(x - mean).mean(dim=axis, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    y = y * gamma.to(x.dtype).reshape(bshape) \
        + beta.to(x.dtype).reshape(bshape)
    return y.to(data.dtype)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

@register_op("BatchNorm", arg_names=("data", "gamma", "beta"),
             aux_names=("moving_mean", "moving_var"),
             mutate_aux=True, takes_train=True,
             num_outputs=lambda p: 3 if p.get("output_mean_var") else 1,
             param_defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                             "use_global_stats": False,
                             "output_mean_var": False, "axis": 1,
                             "cudnn_off": False})
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                _train=False):
    """``(visible outputs..., new_moving_mean, new_moving_var)``: while
    training (and not ``use_global_stats``) the batch statistics
    normalize and the moving ones move by ``momentum``; otherwise the
    moving ones normalize and come back unchanged.  Statistics in at least
    fp32, the biased variance, as the reference's."""
    ax = axis % data.dim()
    dims = tuple(i for i in range(data.dim()) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    if fix_gamma:
        gamma = torch.ones_like(gamma).detach()
    sdt = torch.promote_types(data.dtype, torch.float32)
    if _train and not use_global_stats:
        data_s = data.to(sdt)
        mean = data_s.mean(dim=dims)
        var = data_s.var(dim=dims, unbiased=False)
        new_mm = moving_mean * momentum + \
            mean.detach().to(moving_mean.dtype) * (1 - momentum)
        new_mv = moving_var * momentum + \
            var.detach().to(moving_var.dtype) * (1 - momentum)
    else:
        mean = moving_mean.to(sdt)
        var = moving_var.to(sdt)
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = ((data.to(sdt) - mean.reshape(bshape)) * inv.reshape(bshape)
           * gamma.to(sdt).reshape(bshape)
           + beta.to(sdt).reshape(bshape)).to(data.dtype)
    if output_mean_var:
        return out, mean, inv, new_mm, new_mv
    return out, new_mm, new_mv


alias("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@register_op("Dropout", arg_names=("data",), needs_rng=True,
             takes_train=True, param_defaults={"p": 0.5, "mode": "training"})
def _dropout(data, p=0.5, mode="training", _train=False):
    """Inverted dropout while training (or ``mode="always"``): each
    element kept with probability ``1 - p`` and scaled by ``1 / (1 -
    p)``; the identity otherwise.  The mask comes from
    :func:`mxnet_tpu_torch.random.generator` of the data's device, so
    ``mx.random.seed`` fixes it; the reference's threefry stream cannot be
    reproduced, so the two packages agree by distribution."""
    if (not _train and mode != "always") or p <= 0.0 or \
            data.device.type == "meta":
        return data
    from .. import random as _random
    keep = 1.0 - p
    mask = torch.empty_like(data).bernoulli_(
        keep, generator=_random.generator(data.device))
    return torch.where(mask.bool(), data / keep, torch.zeros_like(data))
