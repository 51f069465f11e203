"""Tensor operators the symbolic path uses (counterpart of part of
``mxnet_tpu/ops/tensor.py``), at the reference's semantics:

- the elementwise and broadcast binary families, the comparison family
  (float 0/1 results in the left operand's dtype) and the scalar family;
- ``negative`` (``-sym``) and the unary ops the NDArray methods reach
  (``abs``, ``exp``, ``log``, ``sqrt``, ``square``, ``relu``,
  ``sigmoid``, ``tanh``), ``clip``;
- the reductions ``sum``, ``mean``, ``max``, ``min`` (``axis``,
  ``keepdims``, ``exclude``) and ``argmax``/``argmin`` (float indices);
- ``Reshape`` with MXNet's special codes 0, -1, -2, -3, -4, ``Flatten``,
  ``broadcast_to``, ``Concat``;
- ``transpose``, ``expand_dims``, ``slice_axis``, ``take``, ``one_hot``,
  ``_onehot_encode``, ``batch_dot``, ``Embedding`` (float token ids) and
  ``_arange``.

Each op is plain torch: autograd supplies the backward.  The remaining
ops of the reference's tensor module are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import alias, register_op

# ---------------------------------------------------------------------------
# Elementwise binary (same-shape) + broadcast variants
# ---------------------------------------------------------------------------

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": torch.remainder,          # jnp.mod: the sign of the divisor
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
}


def _make_binary(fn):
    def _op(lhs, rhs):
        return fn(lhs, rhs)
    return _op


for _name, _fn in _BINARY.items():
    register_op("elemwise_%s" % _name,
                arg_names=("lhs", "rhs"))(_make_binary(_fn))
    register_op("broadcast_%s" % _name,
                arg_names=("lhs", "rhs"))(_make_binary(_fn))

alias("elemwise_add", "_plus", "_add")
alias("elemwise_sub", "_minus", "_sub")
alias("elemwise_mul", "_mul")
alias("elemwise_div", "_div")
alias("elemwise_mod", "_mod")
alias("elemwise_power", "_power", "_pow")
alias("elemwise_maximum", "_maximum")
alias("elemwise_minimum", "_minimum")
alias("broadcast_add", "broadcast_plus")
alias("broadcast_sub", "broadcast_minus")
alias("broadcast_maximum", "maximum")
alias("broadcast_minimum", "minimum")
alias("broadcast_power", "power")
alias("broadcast_hypot", "hypot")

_BINARY_LOGIC = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}


def _make_logic(fn):
    def _op(lhs, rhs):
        # MXNet logic ops return the input's dtype (float 0/1)
        return fn(lhs, rhs).to(lhs.dtype)
    return _op


for _name, _fn in _BINARY_LOGIC.items():
    register_op("broadcast_%s" % _name,
                arg_names=("lhs", "rhs"))(_make_logic(_fn))
    register_op("_%s" % _name, arg_names=("lhs", "rhs"))(_make_logic(_fn))

# ---------------------------------------------------------------------------
# Scalar ops
# ---------------------------------------------------------------------------

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(torch.full_like(x, s), x),
    "_maximum_scalar": lambda x, s: torch.clamp_min(x, s),
    "_minimum_scalar": lambda x, s: torch.clamp_max(x, s),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_hypot_scalar": lambda x, s: torch.hypot(x, torch.full_like(x, s)),
}


def _make_scalar(fn):
    def _op(data, scalar=0.0):
        return fn(data, scalar)
    return _op


for _name, _fn in _SCALAR.items():
    register_op(_name, arg_names=("data",),
                param_defaults={"scalar": 0.0})(_make_scalar(_fn))

alias("_plus_scalar", "_PlusScalar")
alias("_minus_scalar", "_MinusScalar")
alias("_mul_scalar", "_MulScalar")
alias("_div_scalar", "_DivScalar")


@register_op("negative", arg_names=("data",))
def _negative(data):
    return torch.neg(data)


alias("negative", "_neg")

# ---------------------------------------------------------------------------
# Elementwise unary ops (the ones NDArray's methods reach)
# ---------------------------------------------------------------------------

_UNARY = {
    "abs": torch.abs,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": F.relu,
}


def _make_unary(fn):
    def _op(data):
        return fn(data)
    return _op


for _name, _fn in _UNARY.items():
    register_op(_name, arg_names=("data",))(_make_unary(_fn))


@register_op("zeros_like", arg_names=("data",))
def _zeros_like(data):
    return torch.zeros_like(data)


@register_op("where", arg_names=("condition", "x", "y"))
def _where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@register_op("clip", arg_names=("data",),
             param_defaults={"a_min": 0.0, "a_max": 1.0})
def _clip(data, a_min=0.0, a_max=1.0):
    return torch.clamp(data, a_min, a_max)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _reduce_dims(data, axis, exclude=False):
    """The dims to reduce: ``axis`` None or () is every dim; ``exclude``
    reduces every dim but those named."""
    if axis is None or axis == ():
        return tuple(range(data.dim()))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    if exclude:
        return tuple(i for i in range(data.dim())
                     if i not in tuple(a % data.dim() for a in ax))
    return ax


def _sum(data, dims, keepdims):
    out = torch.sum(data, dim=dims, keepdim=keepdims)
    # jnp.sum keeps an integer input's type; torch widens it to int64
    return out if data.is_floating_point() or data.dtype == torch.bool \
        else out.to(data.dtype)


def _mean(data, dims, keepdims):
    if not data.is_floating_point():
        data = data.to(torch.float32)   # jnp.mean of ints is float32
    return torch.mean(data, dim=dims, keepdim=keepdims)


_REDUCE = {
    "sum": _sum,
    "mean": _mean,
    "max": lambda x, dims, keep: torch.amax(x, dim=dims, keepdim=keep),
    "min": lambda x, dims, keep: torch.amin(x, dim=dims, keepdim=keep),
}


def _make_reduce(fn):
    def _op(data, axis=None, keepdims=False, exclude=False):
        return fn(data, _reduce_dims(data, axis, exclude), bool(keepdims))
    return _op


for _name, _fn in _REDUCE.items():
    register_op(_name, arg_names=("data",),
                param_defaults={"axis": None, "keepdims": False,
                                "exclude": False})(_make_reduce(_fn))

alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


def _arg_reduce(fn, data, axis, keepdims):
    """``jnp.argmax``/``argmin`` as float32: ``axis`` None indexes the
    flattened array (``keepdims`` then gives every dim size 1)."""
    if axis is None:
        out = fn(data.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=axis, keepdim=bool(keepdims))
    return out.to(torch.float32)


@register_op("argmax", arg_names=("data",),
             param_defaults={"axis": None, "keepdims": False})
def _argmax(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmax, data, axis, keepdims)


@register_op("argmin", arg_names=("data",),
             param_defaults={"axis": None, "keepdims": False})
def _argmin(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmin, data, axis, keepdims)


@register_op("broadcast_to", arg_names=("data",),
             param_defaults={"shape": ()})
def _broadcast_to(data, shape=()):
    # 0 keeps the input's size, as in the reference
    target = [d if s == 0 else s for s, d in zip(shape, data.shape)]
    return torch.broadcast_to(data, tuple(target))

# ---------------------------------------------------------------------------
# Matrix manipulation
# ---------------------------------------------------------------------------


def _infer_reshape(data_shape, target, reverse=False):
    """MXNet reshape with special codes 0, -1, -2, -3, -4 (the reference's
    ``_infer_reshape``, same cases)."""
    target = list(target)
    src = list(data_shape)
    if reverse:
        src = src[::-1]
        target = target[::-1]
    out = []
    src_idx = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_idx])
            src_idx += 1
        elif t == -1:
            out.append(-1)
            src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:])
            src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src[src_idx]
            src_idx += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 2
        else:
            out.append(int(t))
            if src_idx < len(src):
                src_idx += 1
        i += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@register_op("Reshape", arg_names=("data",),
             param_defaults={"shape": (), "reverse": False})
def _reshape(data, shape=(), reverse=False, target_shape=None,
             keep_highest=False):
    if target_shape:  # legacy param (pre-0.9 API)
        shape = target_shape
    return torch.reshape(data, _infer_reshape(data.shape, shape,
                                              reverse=bool(reverse)))


alias("Reshape", "reshape")


@register_op("Flatten", arg_names=("data",))
def _flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


alias("Flatten", "flatten")


@register_op("transpose", arg_names=("data",), param_defaults={"axes": ()})
def _transpose(data, axes=()):
    axes = tuple(axes) if axes else tuple(range(data.dim() - 1, -1, -1))
    return data.permute(axes)


@register_op("expand_dims", arg_names=("data",), param_defaults={"axis": 0})
def _expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register_op("slice_axis", arg_names=("data",),
             param_defaults={"axis": 0, "begin": 0, "end": None})
def _slice_axis(data, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


def take_filled(a, idx, axis, rows=False):
    """The reference's default ("fill") indexing of ``a`` by int64 ``idx``
    along ``axis``: an index in ``[-n, 0)`` counts from the end, one
    outside ``[-n, n)`` gives NaN.  ``rows=False`` is
    ``jnp.take_along_axis`` (``idx`` has ``a``'s shape but on ``axis``);
    ``rows=True`` is ``jnp.take`` along axis 0 (``idx`` of any shape picks
    rows).  Every index is clamped before it reaches a gather, so nothing
    raises or trips a device assert."""
    n = a.shape[axis]
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.remainder(idx, n),
                       torch.zeros_like(idx))
    if rows:
        out = torch.index_select(a, 0, safe.reshape(-1)) \
            .reshape(idx.shape + a.shape[1:])
        valid = valid.reshape(idx.shape + (1,) * (a.dim() - 1))
    else:
        out = torch.gather(a, axis, safe)
    return torch.where(valid, out, torch.full_like(out, float("nan")))


@register_op("pick", arg_names=("data", "index"),
             param_defaults={"axis": -1, "keepdims": False})
def _pick(data, index, axis=-1, keepdims=False):
    """``jnp.take_along_axis`` of one index per row along ``axis``, in the
    reference's fill mode (:func:`take_filled`: a negative index counts
    from the end, one past the axis gives NaN)."""
    axis = axis % data.dim()
    idx = index.to(torch.int64).unsqueeze(axis)
    out = take_filled(data, idx, axis)
    return out if keepdims else out.squeeze(axis)


@register_op("take", arg_names=("a", "indices"),
             param_defaults={"axis": 0, "mode": "clip"})
def _take(a, indices, axis=0, mode="clip"):
    """``jnp.take``: "wrap" wraps an index, every other mode clips it;
    ``axis`` may count from the end."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" \
        else torch.clamp(idx, 0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _one_hot_rows(indices, depth, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, depth)`` is a zero row
    (``F.one_hot`` would raise)."""
    idx = indices.to(torch.int64)
    return (idx[..., None] == torch.arange(depth, device=idx.device)) \
        .to(dtype)


@register_op("one_hot", arg_names=("indices",),
             param_defaults={"depth": 0, "on_value": 1.0, "off_value": 0.0,
                             "dtype": "float32"})
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32"):
    from ..ndarray.ndarray import to_torch_dtype
    oh = _one_hot_rows(indices, int(depth), to_torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register_op("_onehot_encode", arg_names=("indices", "out"))
def _onehot_encode(indices, out):
    """One-hot rows of ``out``'s shape from ``indices`` (the reference's
    legacy ``mx.nd.onehot_encode``)."""
    if indices.shape[0] != out.shape[0]:
        raise ValueError("onehot_encode: indices length %d != out rows %d"
                         % (indices.shape[0], out.shape[0]))
    return _one_hot_rows(indices, out.shape[1], out.dtype)


@register_op("Concat", arg_names=lambda p: ["arg%d" % i for i in
                                            range(int(p.get("num_args", 2)))],
             param_defaults={"num_args": 2, "dim": 1})
def _concat(*args, num_args=2, dim=1):
    return torch.cat(args, dim=dim)


alias("Concat", "concat")


@register_op("Embedding", arg_names=("data", "weight"),
             param_defaults={"input_dim": 0, "output_dim": 0,
                             "dtype": "float32"},
             backward_ignore=("data",))
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32"):
    # float ids truncate toward zero, as the reference's astype(int32)
    return take_filled(weight, data.to(torch.int64), 0, rows=True)


@register_op("batch_dot", arg_names=("lhs", "rhs"),
             param_defaults={"transpose_a": False, "transpose_b": False})
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


# ---------------------------------------------------------------------------
# Init ops
# ---------------------------------------------------------------------------

@register_op("_arange", arg_names=(),
             param_defaults={"start": 0.0, "stop": None, "step": 1.0,
                             "repeat": 1, "dtype": "float32"})
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            _device=None):
    from ..ndarray.ndarray import to_torch_dtype
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=to_torch_dtype(dtype),
                       device=_device)
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out
