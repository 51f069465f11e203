"""Gluon ``Parameter`` and ``ParameterDict`` (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` holds one NDArray whose tensor is a
``torch.nn.Parameter``: the leaf every forward reads, the tensor the
:class:`~.trainer.Trainer` updates in place, and the tensor the blocks
that own the parameter register with ``torch.nn.Module`` (so ``.to()``,
``.parameters()`` and ``state_dict()`` see it).  :meth:`Parameter.data`
returns that NDArray itself, never a copy; :meth:`Parameter.set_data`,
:meth:`~Parameter.cast` and :meth:`~Parameter.reset_ctx` change its
values, dtype or device in place, so the tensor the optimizer holds stays
the live one.

The gradient has one home: the NDArray's gradient buffer, which is also
the leaf's ``.grad`` (:func:`mxnet_tpu_torch.autograd.mark_variables`).
A forward fed NDArrays is differentiated by
:func:`mxnet_tpu_torch.autograd.backward`, which writes (``grad_req``
``"write"``) or adds (``"add"``) into it; a forward fed raw tensors is
differentiated by torch's ``backward()``, which adds into it, and for a
``"write"`` parameter the block's forward routes the parameter through
:func:`write_grads`, whose backward writes the pass's gradient into the
buffer instead (the sum over every call of the block in the graph).  ``"null"`` parameters get no gradient.  Nothing clears the
buffer after an optimizer step, as in the reference.

Shapes with a 0 defer the initialization to the first forward, which
fills them from the input (each layer's ``infer_shape``).  Devices: a
``ctx`` (a :class:`~mxnet_tpu_torch.context.Context`, a ``torch.device``
or a string) places the data; without one the default device (the card)
is used, as every entry point of the port does.  A list of more than one
context is the multi-device slice (S5) and raises.
"""
from __future__ import annotations

import re

import numpy as _np
import torch

from .. import autograd
from .. import initializer as init_mod
from .. import ndarray as nd
from .. import random as _random
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, to_torch_dtype

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict",
           "write_grads"]


#: a count of structural changes (a block's child, a new parameter, a
#: grad_req), so blocks may cache their parameter lists between them
_STRUCTURE = [0]


def structure_version():
    return _STRUCTURE[0]


def bump_structure():
    _STRUCTURE[0] += 1


class DeferredInitializationError(MXNetError):
    """Parameter is not initialized yet because shape is unknown."""


class _WriteGrads(torch.autograd.Function):
    """The identity on parameters' leaves whose backward writes each
    incoming gradient into its parameter's buffer and passes nothing on:
    MXNet's ``grad_req="write"`` under torch's ``backward()``, which would
    otherwise add into ``.grad``.  "Write" holds for the whole backward
    pass, not for each node: the first node of a pass to reach a buffer
    copies into it and later ones (a block called twice in one recorded
    graph) add, so the buffer ends with the sum of the pass's
    contributions, as the NDArray-fed route gives.  One node for all of a
    forward's parameters: one host call each way and one multi-tensor copy
    and add."""

    @staticmethod
    def forward(ctx, params, *leaves):
        ctx.params = params
        ctx.bufs = [p._data._grad._data for p in params]
        ctx.set_materialize_grads(False)
        return tuple(leaf.view_as(leaf) for leaf in leaves)

    @staticmethod
    def backward(ctx, *grads):
        task = torch._C._current_graph_task_id()
        copies, adds = ([], []), ([], [])
        for p, b, g in zip(ctx.params, ctx.bufs, grads):
            if g is None:
                continue
            pair = adds if p._write_task == task else copies
            p._write_task = task
            pair[0].append(b)
            pair[1].append(g)
        if copies[0]:
            torch._foreach_copy_(*copies)
        if adds[0]:
            torch._foreach_add_(*adds)
        return (None,) * (len(grads) + 1)


def write_grads(params):
    """The tensors a raw-tensor forward reads for ``params`` while
    recording: each ``grad_req="write"`` parameter's leaf through
    :class:`_WriteGrads`, every other one's leaf itself (``"add"``: torch
    adds into the buffer in place; ``"null"``: no gradient)."""
    vals = [p.data()._data for p in params]
    write = [i for i, p in enumerate(params) if p.grad_req == "write"]
    if write:
        views = _WriteGrads.apply([params[i] for i in write],
                                  *[vals[i] for i in write])
        for i, v in zip(write, views):
            vals[i] = v
    return vals


def _one_ctx(ctx):
    if isinstance(ctx, (list, tuple)):
        if len(ctx) > 1:
            raise NotImplementedError(
                "a Parameter on %d devices belongs to the multi-device "
                "slice of the port (S5)" % len(ctx))
        ctx = ctx[0] if ctx else None
    return ctx


class Parameter:
    """A Gluon parameter (reference ``parameter.py:42``)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self._data = None
        self._deferred_init = None
        #: the backward pass that last wrote the gradient (_WriteGrads)
        self._write_task = None
        #: (weak reference to a block, attribute) pairs that register the
        #: leaf with torch
        self._owners = []

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be one of write, add, or null, "
                             "but got %s" % req)
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        bump_structure()
        if self._data is not None:
            self._init_grad()

    # -- initialization ----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Make the data on ``ctx`` and fill it with ``init``, else this
        parameter's own initializer, else ``default_init`` (default
        :class:`~mxnet_tpu_torch.initializer.Uniform`), dispatched on the
        name as the reference's initializers are.  Draws come from
        ``generator``, by default :func:`mxnet_tpu_torch.random.generator`
        of the device.  A shape with a 0 defers the work to the first
        forward when ``allow_deferred_init``; an initialized parameter is
        left as it is unless ``force_reinit``, which refills it in
        place."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if self.shape is None or any(s == 0 for s in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, generator)
                return
            raise ValueError(
                "Cannot initialize Parameter %s because it has invalid "
                "shape: %s." % (self.name, str(self.shape)))
        self._finish_init(init, ctx, default_init, generator)

    def _finish_init(self, init, ctx, default_init, generator=None):
        ctx = _one_ctx(ctx)
        dev = resolve_device(ctx) if ctx is not None or self._data is None \
            else self._data._device
        same = self._data is not None and self._data._device == dev and \
            self._data.shape == tuple(self.shape)
        data = self._data._data.detach() if same else torch.zeros(
            tuple(self.shape), dtype=to_torch_dtype(self.dtype), device=dev)
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        initializer(init_mod.InitDesc(self.name), data,
                    generator if generator is not None
                    else _random.generator(dev))
        if not same:
            self._set_leaf(data)
        self._deferred_init = None

    def _finish_deferred_init(self):
        """Complete deferred init once the shape is known."""
        if self._deferred_init is None:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized" % self.name)
        if self.shape is None or any(s == 0 for s in self.shape):
            raise DeferredInitializationError(
                "Parameter %s still has unknown shape %s" %
                (self.name, self.shape))
        init, ctx, default_init, generator = self._deferred_init
        self._finish_init(init, ctx, default_init, generator)

    def _set_leaf(self, tensor):
        """Hold ``tensor`` as this parameter's leaf (a new NDArray, with its
        gradient buffer) and register it with every owning block."""
        leaf = torch.nn.Parameter(tensor.detach(),
                                  requires_grad=tensor.is_floating_point())
        self._data = NDArray(leaf, leaf.device)
        self.shape = tuple(leaf.shape)
        self._init_grad()
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = leaf

    def _init_grad(self):
        arr = self._data
        if self._grad_req == "null":
            arr._grad = arr._grad_req = None
            arr._data.grad = None
            arr._data.requires_grad_(False)
            return
        arr._data.requires_grad_(True)
        autograd.mark_variables([arr], grad_reqs=self._grad_req)

    # -- access ------------------------------------------------------------
    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s has not been initialized yet because "
                    "initialization was deferred. Actual initialization "
                    "happens during the first forward pass." % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. Note that you "
                "should initialize parameters and create Trainer with "
                "Block.collect_params() instead of Block.params because "
                "the later does not include Parameters of nested child "
                "Blocks" % self.name)

    def data(self, ctx=None):
        """The parameter's NDArray (the live leaf, never a copy)."""
        self._check_initialized()
        arr = self._data
        # torch's Module.to() moves the leaf under the NDArray
        arr._device = arr._data.device
        if arr._grad is not None:
            arr._grad._device = arr._device
        return arr

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer (an NDArray over the leaf's ``.grad``)."""
        arr = self.data()
        if arr._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        return arr._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self.data().context]

    def set_data(self, data):
        """Write ``data`` (an NDArray, tensor or numpy array) into the
        parameter in place; an uninitialized parameter takes its shape and
        completes its (deferred) initialization first, on ``data``'s device
        when nothing else names one."""
        if self._data is None:
            if self.shape is not None and (
                    len(self.shape) != len(data.shape) or
                    any(s not in (0, d)
                        for s, d in zip(self.shape, data.shape))):
                raise ValueError("Parameter %s has shape %s, got data of "
                                 "shape %s" % (self.name, self.shape,
                                               tuple(data.shape)))
            self.shape = tuple(data.shape)
            if self._deferred_init is not None:
                self._finish_deferred_init()
            else:
                src = data._data if isinstance(data, NDArray) else data
                if not isinstance(src, torch.Tensor):
                    src = nd.array(src)._data
                self._set_leaf(src.detach().to(to_torch_dtype(self.dtype),
                                               copy=True))
                return
        arr = self._data
        if tuple(data.shape) != arr.shape:
            raise ValueError("Parameter %s has shape %s, got data of shape "
                             "%s" % (self.name, arr.shape, tuple(data.shape)))
        arr._assign(data)

    def zero_grad(self):
        if self._data is not None and self._data._grad is not None:
            with torch.no_grad():
                self._data._grad._data.zero_()

    def _move(self, device=None, dtype=None):
        """Move (or cast) the leaf and its gradient in place: the tensors
        keep their identity, so every holder sees the new storage."""
        leaf = self._data._data
        with torch.no_grad():
            leaf.data = leaf.data.to(device=device, dtype=dtype)
            if leaf.grad is not None:
                leaf.grad.data = leaf.grad.data.to(device=device,
                                                   dtype=dtype)
        self.data()

    def reset_ctx(self, ctx):
        """Move the data (and gradient) to ``ctx`` in place."""
        if self._data is not None:
            self._move(device=resolve_device(_one_ctx(ctx)))
        elif self._deferred_init is not None:
            init, _, default_init, generator = self._deferred_init
            self._deferred_init = (init, ctx, default_init, generator)

    def cast(self, dtype):
        """Cast the data (and gradient) to ``dtype`` in place."""
        self.dtype = dtype
        if self._data is not None:
            self._move(dtype=to_torch_dtype(dtype))

    def var(self):
        """A symbol Variable of this parameter's name, shape and
        multipliers."""
        from .. import symbol
        return symbol.Variable(self.name, shape=self.shape,
                               lr_mult=self.lr_mult, wd_mult=self.wd_mult)


class ParameterDict:
    """Prefix-scoped dict of Parameters (reference ``parameter.py:195``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "%sParameterDict containing %d parameters" % (
            name, len(self._params))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` if neither
        this dict nor the one it shares has it; an existing one must agree
        with ``kwargs`` (a 0 in a shape agrees with any size and takes
        it)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            bump_structure()
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
                continue
            if k == "shape" and v is not None and \
                    len(v) == len(existing) and \
                    all(a == b or a == 0 or b == 0
                        for a, b in zip(v, existing)):
                param.shape = tuple(max(a, b) for a, b in zip(v, existing))
                continue
            assert str(v) == str(existing) or v is None, \
                "Parameter %s attribute %s mismatch: %s vs %s" % \
                (name, k, str(v), str(existing))
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                assert self._params[k] is v, \
                    "Cannot update self with other because they have " \
                    "different Parameters with the same name %s" % k
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter (``init`` the default of those
        without their own initializer)."""
        if init is None:
            init = init_mod.Uniform()
        elif isinstance(init, str):
            init = init_mod.create(init)
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def _restore(self, name, prefix):
        """The parameter's name for the stored ``name`` under
        ``prefix`` (see :meth:`load`)."""
        full = prefix + name
        if full in self._params:
            return full
        if name in self._params:
            return name
        block = re.fullmatch(r"(.*?)\d+_", prefix)
        other = block and re.match(re.escape(block.group(1)) + r"\d+_",
                                   name)
        return prefix + name[other.end():] if other else full

    def save(self, filename, strip_prefix=""):
        """Every parameter to a V2 ``.params`` file under its name, with
        ``strip_prefix`` taken off where it starts the name."""
        arg_dict = {}
        for param in self.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Parameters from a V2 ``.params`` file (either package's): each
        stored name gets ``restore_prefix`` in front, as the reference's;
        a name that is no parameter so, but is one as it stands or with
        ``restore_prefix`` in place of another instance's prefix of the
        same block (``gptlm0_`` for ``gptlm3_``: a file written without
        ``strip_prefix``), is taken so.  An initialized parameter takes its value in
        place on its device; an uninitialized one is made on ``ctx``
        (default: the card)."""
        arg_dict = nd.load(filename, ctx="cpu")
        if restore_prefix:
            arg_dict = {self._restore(k, restore_prefix): v
                        for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise ValueError("Parameter %s is missing in file %s"
                                     % (name, filename))
        for name, val in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError(
                        "Parameter %s loaded from file %s is not present "
                        "in ParameterDict" % (name, filename))
                continue
            param = self._params[name]
            if param._data is None:
                val = val.as_in_context(resolve_device(_one_ctx(ctx)))
            param.set_data(val)
