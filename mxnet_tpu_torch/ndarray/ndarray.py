"""NDArray: the imperative tensor (counterpart of
``mxnet_tpu/ndarray/ndarray.py``), holding one ``torch.Tensor`` on an
explicit device.

- :func:`imperative_invoke` runs one registered op eagerly: it writes
  mutated aux states back, honours ``out=`` (written only after the op
  has computed, so an output may alias an input, as in
  ``nd.sgd_update(w, g, out=w)``), and records torch's graph only inside
  ``autograd.record()``: outside it every op runs under
  ``torch.no_grad()``, even on marked variables, as MXNet records
  nothing there.  The reference's per-op dispatch counter is dropped: an
  op here is one eager call of torch kernels, with no program to count.
- Writes (``x[:] = v``, ``out=``, an rtc output) copy into the held
  tensor in place under ``torch.no_grad()``, so a marked leaf stays a
  leaf and a bound executor's arguments keep their storage; in-place
  arithmetic (``x += y``) and :meth:`NDArray._set_data` swap the tensor,
  as the reference's do, and keep a marked array a leaf.
- Basic slices return copies, as the reference's do (XLA has no views).
- Left for later slices: sparse storage (``tostype``, S6) and
  ``imdecode`` (S4) raise :class:`MXNetError`.
"""
from __future__ import annotations

import numbers

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, as_device, resolve_device

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "imperative_invoke", "waitall",
           "onehot_encode", "imdecode", "to_torch_dtype"]

_TORCH_DTYPES = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.float64): torch.float64,
    _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.uint8): torch.uint8,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(_np.bool_): torch.bool,
}
_NUMPY_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}

#: what the operators take as a scalar operand
_SCALARS = (numbers.Number, _np.generic)


def to_torch_dtype(dtype):
    """A numpy dtype (or its name, or a torch dtype) as a torch dtype;
    ``None`` is float32.  ``"bfloat16"`` names torch's bfloat16."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    try:
        return _TORCH_DTYPES[_np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def to_numpy_dtype(dtype):
    """A torch dtype as a numpy dtype (bfloat16, which numpy lacks, as the
    string ``"bfloat16"``)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return _NUMPY_DTYPES[dtype]


def _recording():
    from .. import autograd
    return autograd.is_recording()


def _as_tensor(value, device, dtype=None):
    """An NDArray, tensor, numpy array, list or scalar as a tensor on
    ``device`` (float64 numpy data becomes float32, as ``jnp.asarray``
    makes it with x64 off)."""
    if isinstance(value, NDArray):
        value = value._data
    if not isinstance(value, torch.Tensor):
        host = _np.asarray(value)
        if host.dtype == _np.float64:
            host = host.astype(_np.float32)
        value = torch.tensor(host)
    return value.to(device=device, dtype=dtype)


class NDArray:
    """An MXNet-semantics array holding one ``torch.Tensor``."""

    __slots__ = ("_data", "_device", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, device=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray holds a torch.Tensor, got %s"
                            % type(data).__name__)
        self._data = data
        self._device = data.device if device is None else as_device(device)
        self._grad = None
        self._grad_req = None

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return to_numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        """The array's device as a :class:`~..context.Context`."""
        return Context(self._device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def data(self):
        """The held ``torch.Tensor``."""
        return self._data

    @property
    def grad(self):
        """The gradient buffer :meth:`attach_grad` made (``None`` before)."""
        return self._grad

    @property
    def T(self):
        return self.transpose()

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self.context)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    # -- synchronization ---------------------------------------------------
    def wait_to_read(self):
        """Block until the work writing this array is done."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # -- conversions -------------------------------------------------------
    def asnumpy(self):
        """A numpy copy (bfloat16 comes back as float32: numpy has no
        bfloat16).  A copy on the host too: torch's ``numpy()`` would share
        the memory an in-place update (the Trainer's) later writes."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype, copy=True):
        with torch.set_grad_enabled(_recording()):
            return NDArray(self._data.to(to_torch_dtype(dtype), copy=True),
                           self._device)

    def copy(self):
        with torch.set_grad_enabled(_recording()):
            return NDArray(self._data.clone(), self._device)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray: its buffer is replaced by a copy
        on its device) or onto a device (a new NDArray)."""
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            other._set_data(self._data.detach().to(other._device, copy=True))
            return other
        dev = as_device(other)
        return NDArray(self._data.detach().to(dev, copy=True), dev)

    def as_in_context(self, context):
        if as_device(context) == self._device:
            return self
        return self.copyto(context)

    def tostype(self, stype):
        if stype in (None, "default"):
            return self
        raise MXNetError("sparse storage (%r) is not ported yet: slice S6"
                         % (stype,))

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return imperative_invoke("Reshape", (self,), {"shape": shape})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return imperative_invoke("expand_dims", (self,), {"axis": axis})

    def flatten(self):
        return imperative_invoke("Flatten", (self,), {})

    def broadcast_to(self, shape):
        return imperative_invoke("broadcast_to", (self,), {"shape": shape})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return imperative_invoke("transpose", (self,), {"axes": axes})

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array a leaf of the tape with a zero gradient buffer
        (``grad_req`` write or add)."""
        from .. import autograd
        autograd.mark_variables([self], grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach(), self._device)

    # -- mutation ----------------------------------------------------------
    def _set_data(self, new_data):
        """Swap the held tensor (a marked array stays a leaf: a tensor
        with history is detached, the tensor requires grad, and its
        ``.grad`` is the gradient buffer)."""
        if self._grad_req not in (None, "null") and \
                new_data.is_floating_point():
            if new_data.grad_fn is not None:
                new_data = new_data.detach()
            new_data.requires_grad_(True)
            buf = self._grad._data if self._grad is not None else None
            if buf is not None and buf.shape == new_data.shape and \
                    buf.dtype == new_data.dtype and \
                    buf.device == new_data.device:
                new_data.grad = buf
        self._data = new_data

    def _assign(self, value):
        """Write ``value`` into this array in its dtype, in place under
        ``torch.no_grad()``; a value of another shape replaces the held
        tensor instead (the reference swaps its buffer either way)."""
        value = _as_tensor(value, self._data.device, self._data.dtype)
        if tuple(value.shape) == self.shape:
            with torch.no_grad():
                self._data.copy_(value)
        else:
            self._set_data(value.detach())

    def __setitem__(self, key, value):
        """``x[key] = value`` from an NDArray, a tensor, a numpy array or a
        scalar, cast to this array's dtype and device, in place."""
        if not isinstance(value, (NDArray, torch.Tensor, _np.ndarray, list,
                                  tuple) + _SCALARS):
            raise TypeError("cannot assign %s to an NDArray"
                            % type(value).__name__)
        value = _as_tensor(value, self._data.device, self._data.dtype)
        key, flips = self._canon_key(key)
        with torch.no_grad():
            if not flips:
                self._data[key] = value
                return
            # torch has no negative strides: write through the flipped
            # array and flip it back
            flipped = self._data.flip(flips)
            flipped[key] = value
            self._data.copy_(flipped.flip(flips))

    def _canon_key(self, key):
        """``(key, flips)``: the key for torch, with NDArray indices as
        int64 tensors and every slice of negative step rewritten as the
        positive-step slice of the same elements along the flipped axis;
        ``flips`` lists those axes (the reference's jax arrays take
        negative steps, torch does not)."""
        entries = list(key) if isinstance(key, tuple) else [key]
        entries = [k._data.to(torch.int64) if isinstance(k, NDArray) else k
                   for k in entries]
        # the axis each entry indexes: Ellipsis takes what the others
        # leave, None takes none, a boolean mask as many as it has
        def width(k):
            if k is None or k is Ellipsis:
                return 0
            if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
                return k.dim()
            return 1
        rest = self.ndim - sum(width(k) for k in entries)
        flips, axis = [], 0
        for i, k in enumerate(entries):
            if k is Ellipsis:
                axis += rest
                continue
            if isinstance(k, slice) and k.step is not None and k.step < 0:
                n = self.shape[axis]
                start, stop, step = k.indices(n)
                if (stop - start) * step <= 0:
                    entries[i] = slice(0, 0)
                else:
                    entries[i] = slice(n - 1 - start, n - 1 - stop, -step)
                flips.append(axis)
            axis += width(k)
        key = tuple(entries) if isinstance(key, tuple) else entries[0]
        return key, flips

    def __getitem__(self, key):
        key, flips = self._canon_key(key)
        with torch.set_grad_enabled(_recording()):
            data = self._data.flip(flips) if flips else self._data
            return NDArray(data[key].clone(), self._device)

    # -- arithmetic --------------------------------------------------------
    def _binary(self, other, op_name, scalar_op_name, reverse=False):
        if isinstance(other, NDArray):
            args = (other, self) if reverse else (self, other)
            name = op_name if args[0].shape == args[1].shape else \
                op_name.replace("elemwise_", "broadcast_")
            return imperative_invoke(name, args, {})
        if isinstance(other, _SCALARS):
            return imperative_invoke(scalar_op_name, (self,),
                                     {"scalar": float(other)})
        raise TypeError("unsupported operand type %s" % type(other))

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_rminus_scalar",
                            reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    __div__ = __truediv__

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_rdiv_scalar",
                            reverse=True)

    __rdiv__ = __rtruediv__

    def __mod__(self, other):
        return self._binary(other, "elemwise_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binary(other, "elemwise_mod", "_rmod_scalar",
                            reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elemwise_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "elemwise_power", "_rpower_scalar",
                            reverse=True)

    def __neg__(self):
        return imperative_invoke("negative", (self,), {})

    def __abs__(self):
        return imperative_invoke("abs", (self,), {})

    def _inplace(self, out):
        self._set_data(out._data)
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    __idiv__ = __itruediv__

    def _compare(self, other, op_name, scalar_name):
        if isinstance(other, NDArray):
            return imperative_invoke(op_name, (self, other), {})
        return imperative_invoke(scalar_name, (self,),
                                 {"scalar": float(other)})

    def __eq__(self, other):
        if isinstance(other, (NDArray,) + _SCALARS):
            return self._compare(other, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (NDArray,) + _SCALARS):
            return self._compare(other, "broadcast_not_equal",
                                 "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, other):
        return self._compare(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._compare(other, "broadcast_greater_equal",
                             "_greater_equal_scalar")

    def __lt__(self, other):
        return self._compare(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._compare(other, "broadcast_lesser_equal",
                             "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # -- the reference's method surface over registered ops ----------------
    def _unary(name):
        def method(self):
            return imperative_invoke(name, (self,), {})
        method.__name__ = name
        return method

    abs = _unary("abs")
    square = _unary("square")
    sqrt = _unary("sqrt")
    exp = _unary("exp")
    log = _unary("log")
    sigmoid = _unary("sigmoid")
    tanh = _unary("tanh")
    relu = _unary("relu")

    def _reduction(name):
        def method(self, *args, **kwargs):
            if args:
                kwargs = dict(kwargs, axis=args[0])
            return imperative_invoke(name, (self,), kwargs)
        method.__name__ = name
        return method

    sum = _reduction("sum")
    mean = _reduction("mean")
    max = _reduction("max")
    min = _reduction("min")
    argmax = _reduction("argmax")
    argmin = _reduction("argmin")
    del _unary, _reduction

    def clip(self, a_min, a_max):
        return imperative_invoke("clip", (self,),
                                 {"a_min": a_min, "a_max": a_max})

    def softmax(self, *args, **kwargs):
        return imperative_invoke("softmax", (self,), kwargs)

    def slice_axis(self, axis, begin, end):
        return imperative_invoke("slice_axis", (self,),
                                 {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return imperative_invoke("take", (self, indices),
                                 {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kwargs):
        kwargs["depth"] = depth
        return imperative_invoke("one_hot", (self,), kwargs)


# ---------------------------------------------------------------------------
# Imperative invoke (the reference's MXImperativeInvoke)
# ---------------------------------------------------------------------------

def imperative_invoke(op_name, inputs, params, out=None, ctx=None):
    """Run one registered op eagerly on NDArrays (or arrays and scalars,
    placed on the first NDArray's device, else on ``ctx``).  Returns the
    visible outputs (one NDArray, or a list), or ``out`` after writing
    them into it."""
    from ..ops import get_op       # the ops package imports this module
    op = get_op(op_name) if isinstance(op_name, str) else op_name
    params = op.canon_params({k: v for k, v in params.items()
                              if v is not None})
    from .. import autograd
    if op.takes_train:
        params["_train"] = autograd.is_training()
    first = next((a for a in inputs if isinstance(a, NDArray)), None)
    device = first._device if first is not None else resolve_device(ctx)
    if op.takes_device:
        params["_device"] = device
    nd_inputs = [a if isinstance(a, NDArray)
                 else NDArray(_as_tensor(a, device), device)
                 for a in inputs if a is not None]
    with torch.set_grad_enabled(autograd.is_recording()):
        result = op.fn(*[a._data for a in nd_inputs], **params)
    flat = list(result) if isinstance(result, (tuple, list)) else [result]
    n_out = op.num_outputs(params)
    visible, extra = flat[:n_out], flat[n_out:]
    # mutated aux states (BatchNorm's moving statistics): the trailing
    # extra values belong to the trailing inputs, one to one
    if op.mutate_aux and extra:
        for nd_arr, new_val in zip(nd_inputs[-len(extra):], extra):
            nd_arr._assign(new_val)
    outputs = [NDArray(o, device) for o in visible]
    if out is None:
        return outputs[0] if len(outputs) == 1 else outputs
    outs = out if isinstance(out, (list, tuple)) else [out]
    for dst, src in zip(outs, outputs):
        dst._assign(src._data)
    return out if isinstance(out, (list, tuple)) or len(outputs) > 1 \
        else outs[0]


def waitall():
    """Block until all launched work is done (``Engine::WaitForAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Creation routines
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (``None``: the default device, ``cuda:0``)
    from an NDArray, tensor, numpy array or nested list.  A numpy source
    keeps its dtype except float64; everything else defaults to float32,
    as the reference's ``nd.array`` does."""
    dev = resolve_device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        return NDArray(t.to(dev, copy=True), dev)
    np_arr = _np.asarray(source_array)
    if dtype is None:
        if isinstance(source_array, _np.ndarray) and \
                np_arr.dtype != _np.float64:
            dtype = np_arr.dtype
        else:
            dtype = _np.float32
    host = np_arr.astype(_np.float32 if str(dtype) == "bfloat16" else dtype)
    t = torch.from_numpy(_np.ascontiguousarray(host))
    return NDArray(t.to(dev, to_torch_dtype(dtype)), dev)


def _shape(shape):
    return (shape,) if isinstance(shape, numbers.Integral) else tuple(shape)


def full(shape, val, ctx=None, dtype=None):
    """``val`` everywhere, float32 by default, on ``ctx`` (``None``:
    ``cuda:0``)."""
    dev = resolve_device(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=to_torch_dtype(dtype),
                              device=dev), dev)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return full(shape, 0, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return full(shape, 1, ctx=ctx, dtype=dtype)


def empty(shape, ctx=None, dtype=None):
    """Zeros, as the reference's (an uninitialized buffer would differ
    between the packages)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return imperative_invoke("_arange", (), {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": str(_np.dtype(dtype or _np.float32))}, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return imperative_invoke("Concat", tuple(arrays),
                             {"num_args": len(arrays), "dim": axis})


def moveaxis(tensor, source, destination):
    with torch.set_grad_enabled(_recording()):
        return NDArray(torch.movedim(tensor._data, source, destination),
                       tensor._device)


def onehot_encode(indices, out):
    """One-hot rows into ``out`` (the reference's legacy function)."""
    return imperative_invoke("_onehot_encode", (indices, out), {}, out=out)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0,
             channels=3, mean=None):
    raise MXNetError("nd.imdecode is not ported yet: slice S4 (image "
                     "decoding with the host planes)")
