"""Fused-region operators the graph rewrite pipeline emits (counterpart of
``mxnet_tpu/ops/fused.py``).  Each keeps a pattern the pipeline collapses
as ONE node of the rewritten graph:

- ``_fused_conv_bn_act``: Convolution -> BatchNorm (-> Activation).
  While training (and not ``use_global_stats``) it is the composition
  of the same op bodies, so outputs, gradients and moving-statistic
  updates equal the unfused graph's.  Otherwise it folds the
  normalization into the convolution: ``w' = w γ/√(σ² + ε)`` per output
  channel and the bias re-centred, that statistics math in at least
  fp32 (``fix_gamma`` folds ones).
- ``_fused_dense_act``: FullyConnected -> Activation.  It calls the same
  ``F.linear`` as ``FullyConnected`` (the weight is never transposed in
  either), so fused and unfused are bit-identical.
- ``_fused_layer_norm_residual``: LayerNorm(x + r), the transformer
  sublayer epilogue.  On CUDA tensors it launches B4
  (:mod:`.layer_norm`); on CPU tensors B4's plain version runs.
- ``_fused_batch_dot``: batch_dot with the transpose flags; the same
  ``torch.matmul`` on transposed views as ``batch_dot``, so bit-identical.
- ``_graph_constant``: a literal produced by constant folding, holding
  its value out of band (hash and equality by content digest, so CSE
  merges equal folds).

"""
from __future__ import annotations

import hashlib

import numpy as _np
import torch

from . import layer_norm as _ln
from .nn import (_activation, _batch_norm, _convolution, _layer_norm,
                 batch_norm_replicas)
from .registry import register_op

__all__ = ["ConstPayload", "ACT_FUSABLE"]

#: act_type values the fusion pass may fold into a fused region
ACT_FUSABLE = ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
               "gelu_erf")


def _apply_act(out, act_type):
    if act_type in (None, "linear"):
        return out
    return _activation(out, act_type=act_type)


# ---------------------------------------------------------------------------
# Convolution -> BatchNorm (-> Activation)
# ---------------------------------------------------------------------------

def _conv_bn_args(p):
    args = ["data", "weight"] if p.get("no_bias") else \
        ["data", "weight", "bias"]
    return args + ["gamma", "beta"]


@register_op("_fused_conv_bn_act",
             arg_names=_conv_bn_args,
             aux_names=("moving_mean", "moving_var"),
             mutate_aux=True, takes_train=True,
             param_defaults={"kernel": (), "stride": (), "dilate": (),
                             "pad": (), "num_filter": 0, "num_group": 1,
                             "no_bias": False, "workspace": 1024,
                             "cudnn_tune": None, "cudnn_off": False,
                             "layout": None,
                             "eps": 1e-3, "momentum": 0.9,
                             "fix_gamma": True, "use_global_stats": False,
                             "act_type": "linear"})
def _fused_conv_bn_act(data, weight, *rest, kernel=(), stride=(), dilate=(),
                       pad=(), num_filter=0, num_group=1, no_bias=False,
                       workspace=1024, cudnn_tune=None, cudnn_off=False,
                       layout=None, eps=1e-3, momentum=0.9, fix_gamma=True,
                       use_global_stats=False, act_type="linear",
                       _train=False):
    """``(out, new_moving_mean, new_moving_var)``, as BatchNorm returns."""
    if no_bias:
        bias = None
        gamma, beta, moving_mean, moving_var = rest
    else:
        bias, gamma, beta, moving_mean, moving_var = rest
    conv = {"kernel": kernel, "stride": stride, "dilate": dilate,
            "pad": pad, "num_filter": num_filter, "num_group": num_group}
    if _train and not use_global_stats:
        out = _convolution(data, weight, bias, no_bias=no_bias, **conv)
        out, new_mm, new_mv = _batch_norm(
            out, gamma, beta, moving_mean, moving_var, eps=eps,
            momentum=momentum, fix_gamma=fix_gamma, _train=True)
        return _apply_act(out, act_type), new_mm, new_mv
    sdt = torch.promote_types(weight.dtype, torch.float32)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g.to(sdt) * torch.rsqrt(moving_var.to(sdt) + eps)
    w = (weight.to(sdt) * scale.reshape((-1,) + (1,) * (len(kernel) + 1))
         ).to(weight.dtype)
    b = beta.to(sdt) - moving_mean.to(sdt) * scale
    if bias is not None:
        b = b + bias.to(sdt) * scale
    out = _convolution(data, w, b.to(data.dtype), **conv)
    return _apply_act(out, act_type), moving_mean, moving_var


def conv_bn_act_replicas(datas, weights, rests, kernel=(), stride=(),
                         dilate=(), pad=(), num_filter=0, num_group=1,
                         no_bias=False, act_type="linear", eps=1e-3,
                         momentum=0.9, fix_gamma=True, **_):
    """``_fused_conv_bn_act`` in training over replicas: each replica's
    convolution on its device, BatchNorm's statistics over all of them
    (:func:`.nn.batch_norm_replicas`), the activation on each.  ``rests``
    are each replica's trailing inputs (as the op takes them).  Returns
    ``([out] a replica, new_moving_mean, new_moving_var)``."""
    conv = {"kernel": kernel, "stride": stride, "dilate": dilate,
            "pad": pad, "num_filter": num_filter, "num_group": num_group}
    cols = [list(r) if no_bias else list(r[1:]) for r in rests]
    ys = [_convolution(x, w, None if no_bias else r[0], no_bias=no_bias,
                       **conv) for x, w, r in zip(datas, weights, rests)]
    outs, mm, mv = batch_norm_replicas(
        ys, *zip(*cols), eps=eps, momentum=momentum, fix_gamma=fix_gamma)
    return [[_apply_act(o[0], act_type)] for o in outs], mm, mv


# ---------------------------------------------------------------------------
# FullyConnected -> Activation
# ---------------------------------------------------------------------------

@register_op("_fused_dense_act",
             arg_names=lambda p: (["data", "weight"] if p.get("no_bias")
                                  else ["data", "weight", "bias"]),
             param_defaults={"num_hidden": 0, "no_bias": False,
                             "flatten": True, "act_type": "linear"})
def _fused_dense_act(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True, act_type="linear"):
    if flatten and data.dim() > 2:
        data = data.reshape((data.shape[0], -1))
    return _apply_act(torch.nn.functional.linear(data, weight, bias),
                      act_type)


# ---------------------------------------------------------------------------
# LayerNorm(x + r)
# ---------------------------------------------------------------------------

@register_op("_fused_layer_norm_residual",
             arg_names=("lhs", "rhs", "gamma", "beta"),
             param_defaults={"axis": -1, "eps": 1e-5})
def _fused_layer_norm_residual(lhs, rhs, gamma, beta, axis=-1, eps=1e-5):
    """Equal shapes and the last axis: B4 through its autograd Function (the
    kernel on CUDA tensors, which takes float32 and bfloat16 and raises on
    anything else; the plain version on CPU tensors).  A non-last axis, or
    ``MXTPU_LN_PALLAS=0``, keeps the composition."""
    if lhs.shape == rhs.shape and _ln.use_kernel(lhs, axis):
        return _ln.fused_layer_norm_residual(lhs, rhs, gamma, beta, eps=eps)
    if axis not in (-1, lhs.dim() - 1):
        return _layer_norm(lhs + rhs, gamma, beta, axis=axis, eps=eps)
    # the reference's off-TPU lowering of the region (one residual add and
    # the statistics in fp32) is B4's plain version
    lhs, rhs = torch.broadcast_tensors(lhs, rhs)
    d = lhs.shape[-1]
    y = _ln.layer_norm_residual_reference(
        lhs.reshape(-1, d), rhs.reshape(-1, d), gamma, beta, eps)[0]
    return y.reshape(lhs.shape)


# ---------------------------------------------------------------------------
# transpose-free batched contraction
# ---------------------------------------------------------------------------

@register_op("_fused_batch_dot", arg_names=("lhs", "rhs"),
             param_defaults={"transpose_a": False, "transpose_b": False})
def _fused_batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """batch_dot with the transpose flags absorbed: ``torch.matmul`` takes
    the transposed views without a copy, exactly as ``batch_dot`` does."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


# ---------------------------------------------------------------------------
# Folded constants
# ---------------------------------------------------------------------------

class ConstPayload:
    """Out-of-band value holder for ``_graph_constant`` params.  Hash and
    equality by content digest, so two folds of identical subgraphs CSE
    together; a compact repr.  :meth:`on` gives the value as a tensor on a
    device, made once per device and cached: the bind device's executor
    reads the cached device tensor at every forward, never a host copy."""

    __slots__ = ("value", "digest", "_tensors")

    def __init__(self, value):
        self.value = _np.asarray(value)
        self.value.setflags(write=False)
        self.digest = hashlib.sha256(
            b"%s|%s|" % (str(self.value.dtype).encode(),
                         str(self.value.shape).encode())
            + self.value.tobytes()).hexdigest()
        self._tensors = {}

    def on(self, device):
        device = torch.device(device)
        t = self._tensors.get(device)
        if t is None:
            if device.type == "meta":
                # imported here: the ndarray package populates ``nd.<op>``
                # from the registry, so it must not load while ops register
                from ..ndarray.ndarray import to_torch_dtype
                return torch.empty(self.value.shape, device="meta",
                                   dtype=to_torch_dtype(self.value.dtype))
            t = torch.from_numpy(self.value.copy()).to(device)
            self._tensors[device] = t
        return t

    def __hash__(self):
        return hash(self.digest)

    def __eq__(self, other):
        return isinstance(other, ConstPayload) and \
            self.digest == other.digest

    def __repr__(self):
        return "<const %s%s sha256:%s>" % (
            self.value.dtype, list(self.value.shape), self.digest[:12])


@register_op("_graph_constant", arg_names=(),
             param_defaults={"value": None})
def _graph_constant(value=None, _device=None):
    return value.on(_device)
