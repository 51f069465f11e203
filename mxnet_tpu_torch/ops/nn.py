"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``):
``FullyConnected``, ``Convolution`` (alias ``Convolution_v1``),
``Deconvolution``, ``Pooling`` (alias ``Pooling_v1``), ``Activation``,
``LeakyReLU``, ``softmax``, ``log_softmax``, ``SoftmaxActivation``,
``SoftmaxOutput``, ``softmax_cross_entropy``, the regression heads
(``Linear``/``MAE``/``LogisticRegressionOutput``) and ``SVMOutput``,
``BatchNorm``, ``LayerNorm``, ``InstanceNorm``, ``L2Normalization``,
``LRN`` (``F.local_response_norm``, whose formula is the reference's),
``Dropout``, the sequence ops ``SequenceLast``, ``SequenceMask`` and
``SequenceReverse`` (one device gather each, no length read on the host),
``UpSampling`` (nearest; bilinear as a grouped transposed convolution),
``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``,
``ROIPooling`` (vectorized over ROIs), ``Correlation`` and
``IdentityAttachKLSparseReg``.

``Convolution`` and ``Deconvolution`` are ``F.conv{1,2,3}d`` and
``F.conv_transpose{1,2,3}d`` in MXNet's NC(D)HW layout (cuDNN on a CUDA
tensor; a transposed convolution is cut to the reference's output size,
see ``_deconvolution``).  ``Pooling`` pads explicitly where the
reference's ``reduce_window`` padding differs from torch's (the "full"
convention's high-side overhang, a pad above half the kernel), then pools
in torch's floor mode, an ``avg`` dividing by the whole kernel, padding
included.

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
gradient.  The regression and SVM heads do the same with their own
gradients.  ``BilinearSampler`` keeps the reference's border rule (each
corner's index clamped into the image, the weights unclamped) where
``F.grid_sample`` pads with zeros.
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
# Convolution / Deconvolution
# ---------------------------------------------------------------------------

def _tuplize(x, n):
    if x is None or x == ():
        return (1,) * n
    if isinstance(x, int):
        return (x,) * n
    return tuple(x)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op("Convolution",
             arg_names=lambda p: (["data", "weight"] if p.get("no_bias")
                                  else ["data", "weight", "bias"]),
             param_defaults={"kernel": (), "stride": (), "dilate": (),
                             "pad": (), "num_filter": 0, "num_group": 1,
                             "no_bias": False, "workspace": 1024,
                             "cudnn_tune": None, "cudnn_off": False,
                             "layout": None})
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 workspace=1024, cudnn_tune=None, cudnn_off=False,
                 layout=None):
    """NC(D)HW data, OI(D)HW weight, symmetric ``pad``; ``layout`` is
    MXNet's name of that layout, as in the reference, which reads no
    other."""
    ndim = len(kernel)
    return _CONV[ndim](data, weight, bias, _tuplize(stride, ndim),
                       _tuplize(pad if pad else 0, ndim),
                       _tuplize(dilate, ndim), num_group)


@register_op("Deconvolution",
             arg_names=lambda p: (["data", "weight"] if p.get("no_bias", True)
                                  else ["data", "weight", "bias"]),
             param_defaults={"kernel": (), "stride": (), "dilate": (),
                             "pad": (), "adj": (), "target_shape": (),
                             "num_filter": 0, "num_group": 1, "no_bias": True,
                             "workspace": 512, "cudnn_tune": None,
                             "cudnn_off": False, "layout": None})
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, no_bias=True, workspace=512, cudnn_tune=None,
                   cudnn_off=False, layout=None):
    """The transposed convolution, weight ``(in, out / group, *k)`` (torch's
    layout: no flip), each output axis ``(n - 1) stride - 2 pad +
    dilate (k - 1) + 1 + adj`` long; ``target_shape`` is ignored, as in
    the reference.  Its padding formula (an lhs-dilated convolution)
    defines the output for every ``adj`` and ``pad``, where torch's
    ``output_padding`` takes only an ``adj`` below the stride or the
    dilation: so the unpadded transposed convolution is cut from ``pad``
    on, zeros pad it past its end, and the bias is added last."""
    ndim = len(kernel)
    stride = _tuplize(stride, ndim)
    dilate = _tuplize(dilate, ndim)
    pad = _tuplize(pad if pad else 0, ndim)
    adj = _tuplize(adj if adj else 0, ndim)
    out = _CONV_T[ndim](data, weight, None, stride, 0, 0, num_group, dilate)
    for i in range(ndim):
        ax = 2 + i
        size = (data.shape[ax] - 1) * stride[i] - 2 * pad[i] + \
            dilate[i] * (kernel[i] - 1) + 1 + adj[i]
        have = out.shape[ax] - pad[i]
        out = out.narrow(ax, pad[i], min(size, have))
        if size > have:
            fill = list(out.shape)
            fill[ax] = size - have
            out = torch.cat([out, out.new_zeros(fill)], dim=ax)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each window (no padding, floor mode)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register_op("Pooling", arg_names=("data",),
             param_defaults={"kernel": (), "pool_type": "max", "stride": (),
                             "pad": (), "global_pool": False,
                             "pooling_convention": "valid",
                             "cudnn_off": False})
def _pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
             global_pool=False, pooling_convention="valid",
             cudnn_off=False):
    """``max``, ``sum`` or ``avg`` over windows of NC(D)HW data; ``avg``
    counts the padding (divides by the kernel's size).  ``global_pool``
    reduces every spatial axis, ``kernel`` ignored.  The "full"
    convention gives ceil-mode outputs by padding the high side with the
    overhang, as the reference does."""
    ndim = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=dims, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=dims, keepdim=True)
        return torch.mean(data, dim=dims, keepdim=True)
    kernel = _tuplize(kernel, ndim)
    stride = _tuplize(stride, ndim)
    pad = _tuplize(pad if pad else 0, ndim)
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(ndim):
            size = data.shape[2 + i] + 2 * pad[i]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            hi[i] += max(0, (out - 1) * stride[i] + kernel[i] - size)
    if pool_type == "max":
        if list(pad) == hi and all(2 * p <= k for p, k in zip(pad, kernel)):
            return _MAX_POOL[ndim](data, kernel, stride, pad)
        fill = float("-inf") if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        return _MAX_POOL[ndim](_pad_spatial(data, pad, hi, fill), kernel,
                               stride)
    summed = _window_sum(_pad_spatial(data, pad, hi, 0.0), kernel, stride)
    if pool_type == "sum":
        return summed
    denom = 1.0
    for k in kernel:
        denom *= k
    return summed / denom


def _pad_spatial(data, lo, hi, value):
    """``data`` padded by ``lo``/``hi`` on each spatial axis."""
    if not any(lo) and not any(hi):
        return data
    spec = []
    for a, b in zip(reversed(lo), reversed(hi)):
        spec += [a, b]
    return F.pad(data, spec, value=value)


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
                _train=False, _stats=None):
    """``(visible outputs..., new_moving_mean, new_moving_var)``: while
    training (and not ``use_global_stats``) the batch statistics
    normalize and the moving ones move by ``momentum``; otherwise the
    moving ones normalize and come back unchanged.  Statistics in at least
    fp32, the biased variance, as the reference's.  ``_stats`` (mean,
    variance) replaces the batch statistics of ``data`` when ``data`` is
    one replica's slice of the batch (:func:`batch_norm_replicas`)."""
    ax = axis % data.dim()
    dims = tuple(i for i in range(data.dim()) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    if fix_gamma:
        gamma = torch.ones_like(gamma).detach()
    sdt = torch.promote_types(data.dtype, torch.float32)
    if _train and not use_global_stats:
        if _stats is None:
            data_s = data.to(sdt)
            mean = data_s.mean(dim=dims)
            var = data_s.var(dim=dims, unbiased=False)
        else:
            mean, var = _stats
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


def batch_norm_replicas(datas, gammas, betas, mms, mvs, axis=1, **params):
    """Training BatchNorm over replicas (sync-BN): ``datas`` are the
    replicas' slices of one batch, each on its device, and the other
    lists one copy a replica.  The batch statistics are those of the
    slices together, in two passes as one device's (the mean of the
    summed slices, then the biased variance of the summed squared
    deviations), summed on the first replica's device and differentiable
    through the copies; each slice is then normalized on its device.
    Returns ``([visible outputs] a replica, new_moving_mean,
    new_moving_var)``, the moving statistics the first replica's."""
    x0 = datas[0]
    ax = axis % x0.dim()
    dims = tuple(i for i in range(x0.dim()) if i != ax)
    bshape = tuple(x0.shape[ax] if i == ax else 1 for i in range(x0.dim()))
    sdt = torch.promote_types(x0.dtype, torch.float32)
    first = x0.device
    count = sum(x.numel() // x.shape[ax] for x in datas)
    mean = sum(x.to(sdt).sum(dim=dims).to(first) for x in datas) / count
    # the deviations' gradient through the mean sums to zero, and
    # torch.var's backward leaves it out: so does this one
    dev = mean.detach()
    var = sum(((x.to(sdt) - dev.to(x.device).reshape(bshape)) ** 2)
              .sum(dim=dims).to(first) for x in datas) / count
    outs, new = [], None
    for x, g, b, mm, mv in zip(datas, gammas, betas, mms, mvs):
        out = _batch_norm(x, g, b, mm, mv, axis=axis, _train=True,
                          _stats=(mean.to(x.device), var.to(x.device)),
                          **params)
        outs.append(list(out[:-2]))
        new = out[-2:] if new is None else new
    return outs, new[0], new[1]


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


# ---------------------------------------------------------------------------
# Sequence ops (time-major data: (T, N, ...), lengths (N,))
# ---------------------------------------------------------------------------

def _sequence_args(p):
    return ["data", "sequence_length"] if p.get("use_sequence_length") \
        else ["data"]


@register_op("SequenceLast", arg_names=_sequence_args,
             param_defaults={"use_sequence_length": False})
def _sequence_last(data, sequence_length=None, use_sequence_length=False):
    """The last valid step of each sequence: ``data[len - 1, n]``, one
    gather on the device (no length is read on the host)."""
    if not use_sequence_length:
        return data[-1]
    idx = sequence_length.to(torch.int64) - 1
    return data[idx, torch.arange(data.shape[1], device=data.device)]


@register_op("SequenceMask", arg_names=_sequence_args,
             param_defaults={"use_sequence_length": False, "value": 0.0})
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0):
    """``value`` at every step ``t >= len`` of each sequence."""
    if not use_sequence_length:
        return data
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    mask = t < sequence_length.to(torch.int64)[None, :]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


@register_op("SequenceReverse", arg_names=_sequence_args,
             param_defaults={"use_sequence_length": False})
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False):
    """The first ``len`` steps of each sequence reversed, the padding
    after them in place."""
    if not use_sequence_length:
        return torch.flip(data, (0,))
    T = data.shape[0]
    lens = sequence_length.to(torch.int64)[None, :]
    t = torch.arange(T, device=data.device)[:, None]
    src = torch.where(t < lens, lens - 1 - t, t)
    return data[src, torch.arange(data.shape[1], device=data.device)[None, :]]


alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")


# ---------------------------------------------------------------------------
# Softmax activation and cross entropy
# ---------------------------------------------------------------------------

@register_op("SoftmaxActivation", arg_names=("data",),
             param_defaults={"mode": "instance"})
def _softmax_activation(data, mode="instance"):
    """``channel``: softmax over axis 1; ``instance``: over each sample's
    flattened values."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape((data.shape[0], -1)),
                         dim=-1).reshape(data.shape)


@register_op("softmax_cross_entropy", arg_names=("data", "label"),
             backward_ignore=("label",))
def _softmax_cross_entropy(data, label):
    """The summed cross entropy of each row's log-softmax at its label,
    shape ``(1,)`` (an index outside the row gives NaN, as the
    reference's fill-mode gather)."""
    from .tensor import take_filled
    logp = torch.log_softmax(data, dim=-1)
    picked = take_filled(logp, label.to(torch.int64)[:, None], 1)
    return -torch.sum(picked).reshape((1,))


# ---------------------------------------------------------------------------
# Regression and SVM heads: implicit gradients, the head gradient ignored
# ---------------------------------------------------------------------------

class _RegressionOutput(torch.autograd.Function):
    """Forward: ``fwd(data)``.  Backward: ``grad_fn(out, label)`` times
    ``grad_scale`` over the outputs a sample (regression_output-inl.h),
    whatever flows in from above; the label gets zeros."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad_fn, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad_fn, ctx.grad_scale = grad_fn, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        n = out.numel() // out.shape[0] if out.dim() > 1 else 1
        grad = ctx.grad_fn(out, label.reshape(out.shape)) * \
            (ctx.grad_scale / n)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad.to(out.dtype), dlabel, None, None, None


def _make_regression(name, fwd, grad_fn):
    @register_op(name, arg_names=("data", "label"),
                 backward_ignore=("label",),
                 param_defaults={"grad_scale": 1.0})
    def _op(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, fwd, grad_fn,
                                       grad_scale)
    _op.__doc__ = "Regression head ``%s`` (implicit gradient)." % name
    return _op


_make_regression("LinearRegressionOutput", lambda x: x,
                 lambda out, label: out - label)
_make_regression("MAERegressionOutput", lambda x: x,
                 lambda out, label: torch.sign(out - label))
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda out, label: out - label)


class _SVMOutput(torch.autograd.Function):
    """Forward: the identity.  Backward: the hinge gradient of each score
    against its one-hot target (+1 for the label's class, -1 for the
    others), squared hinge unless ``use_linear``."""

    @staticmethod
    def forward(ctx, data, label, margin, coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.p = (margin, coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        from .tensor import _one_hot_rows
        d, label = ctx.saved_tensors
        margin, coef, use_linear = ctx.p
        y = 2.0 * _one_hot_rows(label, d.shape[1], d.dtype) - 1.0
        gap = margin - y * d
        viol = gap > 0
        grad = -y * coef if use_linear else -2.0 * coef * gap * y
        grad = torch.where(viol, grad, torch.zeros_like(grad))
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad.to(d.dtype), dlabel, None, None, None


@register_op("SVMOutput", arg_names=("data", "label"),
             backward_ignore=("label",),
             param_defaults={"margin": 1.0,
                             "regularization_coefficient": 1.0,
                             "use_linear": False})
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            bool(use_linear))


# ---------------------------------------------------------------------------
# Other normalizations
# ---------------------------------------------------------------------------

@register_op("LRN", arg_names=("data",),
             param_defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                             "nsize": 5})
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Cross-channel local response norm: ``data / (knorm + alpha / nsize
    * sum of squares over nsize channels) ** beta``, the window centred
    (odd ``nsize``), zeros past the edges: ``F.local_response_norm``,
    whose formula this is."""
    x = data if data.dim() >= 3 else data.unsqueeze(-1)
    out = F.local_response_norm(x, int(nsize), alpha=alpha, beta=beta,
                                k=knorm)
    return out if data.dim() >= 3 else out.squeeze(-1)


@register_op("InstanceNorm", arg_names=("data", "gamma", "beta"),
             param_defaults={"eps": 1e-3})
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Each sample's channel normalized over its spatial axes (biased
    variance), then scaled by ``gamma`` and shifted by ``beta``."""
    dims = tuple(range(2, data.dim()))
    mean = data.mean(dim=dims, keepdim=True)
    var = torch.square(data - mean).mean(dim=dims, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


@register_op("L2Normalization", arg_names=("data",),
             param_defaults={"eps": 1e-10, "mode": "instance"})
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data ** 2) + eps)`` over each sample
    (``instance``), its channel axis (``channel``) or its spatial axes
    (``spatial``)."""
    if mode == "instance":
        dims = tuple(range(1, data.dim()))
    elif mode == "channel":
        dims = (1,)
    else:
        dims = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=dims,
                                       keepdim=True) + eps)


# ---------------------------------------------------------------------------
# Spatial ops: UpSampling, BilinearSampler, GridGenerator,
# SpatialTransformer, ROIPooling, Correlation
# ---------------------------------------------------------------------------

def _upsampling_args(p):
    # bilinear: data and weight; nearest: data, or arg0..argN-1
    if p.get("sample_type") == "bilinear":
        return ["data", "weight"]
    n = int(p.get("num_args", 1))
    return ["data"] if n == 1 else ["arg%d" % i for i in range(n)]


@register_op("UpSampling", arg_names=_upsampling_args,
             param_defaults={"scale": 1, "num_filter": 0,
                             "sample_type": "nearest",
                             "multi_input_mode": "concat", "num_args": 1,
                             "workspace": 512})
def _upsampling(*args, scale=1, num_filter=0, sample_type="nearest",
                multi_input_mode="concat", num_args=1, workspace=512):
    """``nearest``: each input repeated up to the first input's height
    times ``scale``, then concatenated on channels or summed.
    ``bilinear``: a transposed convolution with one group a channel,
    weight ``(C, 1, k, k)``, ``k = 2 scale - scale % 2``, stride
    ``scale``, pad ``ceil((scale - 1) / 2)``."""
    if sample_type == "bilinear":
        data, weight = args
        c = data.shape[1]
        k = weight.shape[-1]
        pad = -(-(scale - 1) // 2)
        return _deconvolution(data, weight, kernel=(k, k),
                              stride=(scale, scale), pad=(pad, pad),
                              num_filter=c, num_group=c, no_bias=True)
    target = args[0].shape[2] * scale
    outs = []
    for a in args:
        s = target // a.shape[2]
        outs.append(torch.repeat_interleave(
            torch.repeat_interleave(a, s, dim=2), s, dim=3))
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


def bilinear_sample(data, gx, gy):
    """``data`` ``(N, C, H, W)`` sampled at pixel coordinates ``gx``,
    ``gy`` ``(N, Ho, Wo)``: the four corners' indices each clamped into
    the image, their weights the unclamped distances (the reference's
    BilinearSampler); ``(N, C, Ho, Wo)``."""
    N, C, H, W = data.shape
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    flat = data.reshape(N, C, H * W)

    def corner(y, x):
        yi = torch.clamp(y, 0, H - 1).to(torch.int64)
        xi = torch.clamp(x, 0, W - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(N, 1, -1).expand(N, C, -1)
        return torch.gather(flat, 2, idx).reshape((N, C) + gx.shape[1:])

    def w(t):
        return t.unsqueeze(1)

    return (corner(y0, x0) * w((1 - wx) * (1 - wy))
            + corner(y0, x0 + 1) * w(wx * (1 - wy))
            + corner(y0 + 1, x0) * w((1 - wx) * wy)
            + corner(y0 + 1, x0 + 1) * w(wx * wy))


@register_op("BilinearSampler", arg_names=("data", "grid"))
def _bilinear_sampler(data, grid):
    """``grid`` ``(N, 2, Ho, Wo)`` of (x, y) in [-1, 1] at align-corners
    coordinates ``(g + 1)(W - 1) / 2``; a grid past the border reads the
    clamped border pixels with the unclamped weights (unlike
    ``F.grid_sample``'s zero padding)."""
    _, _, H, W = data.shape
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return bilinear_sample(data, gx, gy)


@register_op("GridGenerator", arg_names=("data",),
             param_defaults={"transform_type": "affine",
                             "target_shape": (0, 0)})
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """``affine``: ``data`` is each sample's 2 x 3 matrix, applied to the
    target grid's (x, y, 1) with x, y in [-1, 1]; ``warp``: ``data`` is a
    flow field ``(N, 2, H, W)`` in pixels added to the pixel grid, then
    normalized to [-1, 1].  Returns ``(N, 2, H, W)``."""
    H, W = int(target_shape[0]), int(target_shape[1])
    N = data.shape[0]
    if transform_type == "affine":
        if data.numel() != N * 6:
            raise TypeError("cannot reshape array of shape %s (size %d) "
                            "into shape (%d, 2, 3)"
                            % (tuple(data.shape), data.numel(), N))
        theta = data.reshape(N, 2, 3)
        ys = torch.linspace(-1.0, 1.0, H, dtype=data.dtype,
                            device=data.device)
        xs = torch.linspace(-1.0, 1.0, W, dtype=data.dtype,
                            device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)])
        return torch.einsum("nij,jk->nik", theta, coords).reshape(N, 2, H, W)
    H, W = data.shape[2], data.shape[3]
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=data.dtype, device=data.device),
        torch.arange(W, dtype=data.dtype, device=data.device),
        indexing="ij")
    gx = (gx + data[:, 0]) * 2.0 / (W - 1) - 1.0
    gy = (gy + data[:, 1]) * 2.0 / (H - 1) - 1.0
    return torch.stack([gx, gy], dim=1)


@register_op("SpatialTransformer", arg_names=("data", "loc"),
             param_defaults={"target_shape": (0, 0),
                             "transform_type": "affine",
                             "sampler_type": "bilinear"})
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear"):
    """The affine grid of ``loc`` (each sample's 2 x 3 matrix: a ``loc``
    of another size raises ``TypeError``, as the reference's reshape
    does) sampled by :func:`_bilinear_sampler`."""
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=target_shape)
    return _bilinear_sampler(data, grid)


#: elements of the masked tensor one ROIPooling chunk builds (ROIs are
#: taken this many at a time, never one by one)
ROI_CHUNK_ELEMENTS = 1 << 26


@register_op("ROIPooling", arg_names=("data", "rois"),
             param_defaults={"pooled_size": (0, 0), "spatial_scale": 1.0})
def _roi_pooling(data, rois, pooled_size=(0, 0), spatial_scale=1.0):
    """Max pooling of each ROI ``[batch, x1, y1, x2, y2]`` (corners
    scaled by ``spatial_scale`` and rounded half to even) into
    ``pooled_size`` bins, ``floor``/``ceil`` bin edges; an empty bin is
    0.  Vectorized over ROIs: the bins' column maxima, then their row
    maxima (masked maxima, as the reference's), a chunk of ROIs at a
    time."""
    from .tensor import clamp_index
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    R = rois.shape[0]
    if R == 0 or data.device.type == "meta":
        return data.new_zeros((R, C, PH, PW))
    dev = data.device
    box = torch.round(rois[:, 1:5] * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = box.unbind(1)
    rh = torch.clamp(y2 - y1 + 1, min=1).to(torch.float32)
    rw = torch.clamp(x2 - x1 + 1, min=1).to(torch.float32)
    ph = torch.arange(PH, device=dev, dtype=torch.float32)
    pw = torch.arange(PW, device=dev, dtype=torch.float32)
    hs = torch.floor(ph * rh[:, None] / PH).to(torch.int64) + y1[:, None]
    he = torch.ceil((ph + 1) * rh[:, None] / PH).to(torch.int64) + \
        y1[:, None]
    ws = torch.floor(pw * rw[:, None] / PW).to(torch.int64) + x1[:, None]
    we = torch.ceil((pw + 1) * rw[:, None] / PW).to(torch.int64) + \
        x1[:, None]
    yy = torch.arange(H, device=dev)
    xx = torch.arange(W, device=dev)
    ymask = (yy >= hs[..., None]) & (yy < he[..., None])      # (R, PH, H)
    xmask = (xx >= ws[..., None]) & (xx < we[..., None])      # (R, PW, W)
    b = clamp_index(rois[:, 0].to(torch.int64), N)[0]
    neg = torch.tensor(float("-inf"), dtype=data.dtype, device=dev)
    step = max(1, ROI_CHUNK_ELEMENTS // max(1, C * H * W * max(PH, PW)))
    outs = []
    for s in range(0, R, step):
        img = data[b[s:s + step]]                              # (r,C,H,W)
        cols = torch.where(xmask[s:s + step, None, None],
                           img[:, :, :, None, :], neg).amax(-1)
        outs.append(torch.where(ymask[s:s + step, None, :, :, None],
                                cols[:, :, None], neg).amax(3))
    out = torch.cat(outs)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


@register_op("Correlation", arg_names=("data1", "data2"),
             param_defaults={"kernel_size": 1, "max_displacement": 1,
                             "stride1": 1, "stride2": 1, "pad_size": 0,
                             "is_multiply": True})
def _correlation(data1, data2, kernel_size=1, max_displacement=1,
                 stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """The reference's FlowNet correlation: for each displacement in
    ``[-max_displacement, max_displacement]`` (step ``stride2``) the
    channel mean of ``data1 * shifted data2`` (``|data1 - shifted|``
    without ``is_multiply``) on the zero-padded maps, the shift wrapping
    around the border (``jnp.roll``); ``kernel_size`` is not read; then
    every ``stride1``-th position."""
    d = int(max_displacement)
    spec = [pad_size] * 4
    a = F.pad(data1, spec)
    b = F.pad(data2, spec)
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            shifted = torch.roll(b, (-dy, -dx), dims=(2, 3))
            outs.append(torch.mean(a * shifted if is_multiply
                                   else torch.abs(a - shifted), dim=1))
    return torch.stack(outs, dim=1)[:, :, ::stride1, ::stride1]


@register_op("IdentityAttachKLSparseReg", arg_names=("data",),
             param_defaults={"sparseness_target": 0.1, "penalty": 0.001,
                             "momentum": 0.9})
def _identity_attach_kl(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9):
    """The identity (the reference attaches no penalty)."""
    return data.clone()
