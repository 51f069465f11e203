"""Gluon ``Block``, ``HybridBlock`` and ``SymbolBlock`` (counterpart of
``mxnet_tpu/gluon/block.py``).

A :class:`Block` is a ``torch.nn.Module`` with Gluon's name scopes and a
:class:`~.parameter.ParameterDict`; every initialized
:class:`~.parameter.Parameter` it holds as an attribute is registered
with torch under that attribute, so ``.to()``, ``.parameters()`` and
``state_dict()`` keep working.  Called outside
:func:`~mxnet_tpu_torch.autograd.record` a block runs under
``torch.no_grad()``, as MXNet records nothing there.

A :class:`HybridBlock` computes in ``hybrid_forward(F, x, ...)`` and is
called in one of three ways, by its first input:

- **NDArrays, not hybridized** (eager): ``F`` is ``mx.nd``, the
  parameters their NDArrays; ``autograd.backward`` differentiates it.
- **NDArrays, hybridized** (``hybridize()``): a CachedOp.  The
  reference's CachedOp is one jitted XLA program for the whole block;
  here it is one of two evaluators over raw tensors, run under torch's
  grad mode while recording:

  - *the symbolic route*: ``hybrid_forward`` is traced once with a
    Symbol-emitting ``F``, the rewrite pipeline (:func:`~mxnet_tpu_torch.
    graph.optimize`) rewrites the graph (LayerNorm(x + r) into the fused
    B4 node, dense + activation, folding, CSE, DCE) and the rewritten
    graph is evaluated node by node by
    :func:`~mxnet_tpu_torch.executor.build_plan`, the executor's
    evaluator; the pass report is kept on ``_cached_graph_report``;
  - *the traced route*, when the block does not trace symbolically (it
    reads ``x.shape``, as the GPT stack does): ``hybrid_forward`` runs
    with ``F`` the op registry over raw torch tensors (so
    ``F._contrib_flash_attention`` launches B1-B3/B7).

  Either way the new values of aux parameters (BatchNorm's moving
  statistics, ``mutate_aux``) are written into them after the call, as
  the reference's CachedOp writes its aux outputs back.
- **raw torch tensors** (the reference's raw-array dispatch): the traced
  route, returning tensors; torch's ``backward()`` differentiates it, with
  each ``grad_req="write"`` parameter read through
  :func:`~.parameter.write_grads` while recording.

Deferred shapes (a 0 in a parameter's shape) are filled by each layer's
``infer_shape`` at its first eager call; a hybridized or raw-fed block
first runs one eager pass under ``autograd.pause``.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import get_op
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, bump_structure, structure_version,
                        write_grads)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "functionalize"]


# ---------------------------------------------------------------------------
# Trace state and the two functional namespaces
# ---------------------------------------------------------------------------

_STATE = threading.local()


class _TraceCtx:
    """One traced evaluation: ``params`` maps each parameter's name to the
    value the trace reads (a tensor or a Symbol); ``aux_updates`` collects
    ``(aux tensor, new value)`` pairs for the write-back."""

    def __init__(self, params, train, symbolic=False, device=None):
        self.params = params
        self.train = train
        self.symbolic = symbolic
        self.device = device
        self.aux_updates = []


def current_trace():
    """The innermost trace, or None."""
    return getattr(_STATE, "trace", None)


@contextlib.contextmanager
def trace_scope(ctx):
    prev = current_trace()
    _STATE.trace = ctx
    try:
        yield ctx
    finally:
        _STATE.trace = prev


def _eager_once():
    return getattr(_STATE, "eager_once", False)


class _TorchF:
    """``F`` of the traced route: each registered op over raw tensors, with
    the trace's train flag; an op's aux-state outputs are recorded for the
    write-back."""

    def __init__(self):
        self._calls = {}

    def __getattr__(self, name):
        call = self._calls.get(name)
        if call is None:
            call = self._calls[name] = self._make(name)
        return call

    @staticmethod
    def _make(name):
        op = get_op(name)
        plain = not (op.takes_train or op.takes_device or op.mutate_aux
                     or callable(op._num_outputs) or op._num_outputs != 1)

        def call(*args, **params):
            if plain:       # one output, nothing from the trace
                return op.fn(*args, **op.canon_params(params))
            ctx = current_trace()
            if op.takes_train:
                params["_train"] = ctx.train if ctx is not None \
                    else autograd.is_training()
            if op.takes_device:
                params["_device"] = ctx.device if ctx is not None else None
            out = op.fn(*args, **op.canon_params(params))
            flat = list(out) if isinstance(out, (tuple, list)) else [out]
            n_vis = op.num_outputs(params)
            vis, extra = flat[:n_vis], flat[n_vis:]
            if extra and ctx is not None:
                # trailing aux inputs correspond 1:1 to the extras
                ctx.aux_updates.extend(zip(args[len(args) - len(extra):],
                                           extra))
            return vis[0] if len(vis) == 1 else tuple(vis)
        call.__name__ = name
        return call


class _SymF:
    """``F`` of the symbolic route: each registered op emitting a Symbol
    graph node."""

    def __init__(self):
        self._calls = {}

    def __getattr__(self, name):
        call = self._calls.get(name)
        if call is None:
            from ..symbol import symbol as _sym
            call = self._calls[name] = _sym.make_symbol_function(
                get_op(name), name)
        return call


_F_TORCH = _TorchF()
_F_SYM = _SymF()


# ---------------------------------------------------------------------------
# Name scoping
# ---------------------------------------------------------------------------

class _BlockScope:
    """Name/prefix management (reference ``block.py:29``)."""

    _current = threading.local()

    def __init__(self, block):
        # weak: a block and its scope would otherwise keep each other (and
        # the block's device memory) alive until a cyclic collection
        self._block = weakref.proxy(block)
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _global_count(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_GLOBAL_COUNTERS = {}


def _global_count(hint):
    count = _GLOBAL_COUNTERS.get(hint, 0)
    _GLOBAL_COUNTERS[hint] = count + 1
    return "%s%d" % (hint, count)


def _device_arg(device, ctx):
    """One device from the port's ``device=`` or Gluon's ``ctx=``."""
    if ctx is None:
        return device
    if device is not None:
        raise ValueError("give device or ctx, not both")
    return ctx


def _indent(s, num_spaces):
    lines = s.split("\n")
    first = lines.pop(0)
    return first + ("\n" + " " * num_spaces).join([""] + lines) \
        if lines else first


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block(torch.nn.Module):
    """Base of all layers and models (reference ``block.py:115``)."""

    def __init__(self, prefix=None, params=None):
        torch.nn.Module.__init__(self)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(
            "  ({key}): {block}".format(key=i, block=_indent(str(block), 2))
            for i, block in enumerate(self._children))
        return s.format(name=self.__class__.__name__, modstr=modstr) \
            if self._children else self.__class__.__name__ + "()"

    def __setattr__(self, name, value):
        d = self.__dict__
        existing = d.get(name, d.get("_modules", {}).get(name))
        if isinstance(existing, (Parameter, Block)) and \
                not isinstance(value, type(existing)):
            raise TypeError("Changing attribute type for %s from %s to %s "
                            "is not allowed." % (name, type(existing),
                                                 type(value)))
        if isinstance(value, Block):
            if existing is not value:
                self.register_child(value, name)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            if name in self._reg_params:
                return
            self._reg_params[name] = value
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            value._owners.append((weakref.ref(self), name))
            if value._data is not None:
                self._parameters[name] = value._data._data

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        """This block's and every descendant's parameters, in registration
        order."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children:
            ret.update(child.collect_params())
        return ret

    def save_params(self, filename):
        """Every parameter to a V2 ``.params`` file, this block's prefix
        taken off the names (either package's ``load_params`` reads it)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False, device=None):
        """Parameters from a V2 ``.params`` file (either package's), names
        with or without this block's prefix; see
        :meth:`~.parameter.ParameterDict.load`.  Returns ``self``."""
        self.collect_params().load(filename, _device_arg(device, ctx),
                                   allow_missing, ignore_extra,
                                   restore_prefix=self.prefix)
        return self

    def register_child(self, block, name=None):
        """Add ``block`` as a child (``name``: the attribute it is set as;
        none for a container's children)."""
        self._children.append(block)
        bump_structure()
        if name is None:
            torch.nn.Module.add_module(self, str(len(self._children) - 1),
                                       block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, device=None, generator=None):
        """Initialize every parameter on ``ctx`` (or the port's
        ``device=``; default: the card), ``init`` the default of those
        without their own initializer; draws from ``generator`` (default:
        :func:`mxnet_tpu_torch.random.generator` of the device).  Returns
        ``self``."""
        self.collect_params().initialize(init, _device_arg(device, ctx),
                                         verbose, force_reinit,
                                         generator=generator)
        return self

    def hybridize(self, active=True):
        for child in self._children:
            child.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args, **kwargs):
        # MXNet records a graph only inside autograd.record()
        if autograd.is_recording():
            return super().__call__(*args, **kwargs)
        with torch.no_grad():
            return super().__call__(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# The CachedOp
# ---------------------------------------------------------------------------

class _CachedOp:
    """A hybridized block's evaluator over raw tensors: the rewritten
    graph's ``plan`` (the symbolic route) or ``hybrid_forward`` with the
    registry's torch ``F`` (the traced route).  ``params``: the block's
    parameters, differentiable ones first, then the aux ones
    (``grad_req="null"``)."""

    def __init__(self, block, params, key, plan=None, in_names=None):
        # weak: the block holds its CachedOp
        self.block = weakref.proxy(block)
        self.params = params
        self.key = key
        self.plan = plan
        self.in_names = in_names
        self.names = [p.name for p in params]
        # fixed when the op is built, as the reference's
        # _cached_param_list: the op returns new aux values in this order
        self.aux_params = [p for p in params if p.grad_req == "null"]
        self.aux_names = [p.name for p in self.aux_params]

    def run(self, inputs, param_vals, train, device=None, kwargs=None):
        """``(outs, new_aux)`` from raw ``inputs`` and parameter values
        (in :attr:`params` order); nothing is written."""
        vals = dict(zip(self.names, param_vals))
        if self.plan is not None:
            args = {n: v for n, v in zip(self.in_names, inputs)
                    if v is not None}
            args.update(vals)
            aux = {n: vals[n] for n in self.aux_names}
            new = {}
            outs = self.plan(args, aux, train, aux_out=new)
            return outs, [new.get(n, aux[n]) for n in self.aux_names]
        ctx = _TraceCtx(vals, train, device=device)
        with trace_scope(ctx):
            out = self.block._call_traced(*inputs, **(kwargs or {}))
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        upd = {id(t): v for t, v in ctx.aux_updates}
        return outs, [upd.get(id(vals[n]), vals[n]) for n in self.aux_names]

    def __call__(self, args, kwargs=None):
        """Run on NDArrays (NDArrays out, a list for several outputs) or on
        raw tensors (tensors out, as ``hybrid_forward`` returns them);
        writes the new aux values into the aux parameters."""
        fed_nd = isinstance(args[0], NDArray)
        recording = autograd.is_recording()
        if fed_nd:
            device = args[0]._device
            inputs = [a._data if isinstance(a, NDArray) else a for a in args]
            vals = [p.data()._data for p in self.params]
        else:
            device = args[0].device if isinstance(args[0], torch.Tensor) \
                else None
            inputs = list(args)
            vals = write_grads(self.params) if recording else \
                [p.data()._data for p in self.params]
        with torch.set_grad_enabled(recording):
            outs, new_aux = self.run(inputs, vals, autograd.is_training(),
                                     device, kwargs)
        for p, new in zip(self.aux_params, new_aux):
            old = p.data()
            if new is not old._data:
                old._assign(new.detach())
        if not fed_nd:
            if self.plan is None:
                return outs[0] if len(outs) == 1 else tuple(outs)
            return outs[0] if len(outs) == 1 else outs
        wrapped = [NDArray(o, device) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else wrapped


def _ordered_params(block):
    """``block``'s parameters, differentiable ones first, then the aux
    ones; kept on the block until a block, parameter or ``grad_req``
    anywhere changes (:func:`~.parameter.structure_version`)."""
    version = structure_version()
    cached = block.__dict__.get("_plist")
    if cached is not None and cached[0] == version:
        return cached[1]
    plist = list(block.collect_params().values())
    plist = [p for p in plist if p.grad_req != "null"] + \
        [p for p in plist if p.grad_req == "null"]
    block._plist = (version, plist)
    return plist


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------

class HybridBlock(Block):
    """Block with a ``hybrid_forward`` (reference ``block.py:283``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        #: the rewrite pipeline's report of the symbolic route
        self._cached_graph_report = None

    def hybridize(self, active=True):
        self._active = active
        self._cached_op = None
        super().hybridize(active)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s." % (str(block), str(type(block))))
        super().register_child(block, name)
        self._cached_op = None

    # -- eager path --------------------------------------------------------
    def _call_eager(self, *args, **kwargs):
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(*args)
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd, *args, **kwargs, **params)

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def infer_shape(self, *args):
        """Layers with deferred params override this to fill shapes."""
        raise MXNetError(
            "Deferred initialization failed because shape cannot be "
            "inferred for %s. Override infer_shape." % self.name)

    def _finish_deferred_recursive(self, *args):
        """One eager pass (no recording, no CachedOp) resolves every
        nested deferred shape."""
        nd_args = [NDArray(a) if isinstance(a, torch.Tensor) else a
                   for a in args]
        prev = _eager_once()
        _STATE.eager_once = True
        try:
            with autograd.pause():
                self(*nd_args)
        finally:
            _STATE.eager_once = prev

    def _check_params(self, args):
        plist = _ordered_params(self)
        if any(p._data is None for p in plist):
            self._finish_deferred_recursive(*args)
        return plist

    # -- traced path -------------------------------------------------------
    def _call_traced(self, *args, **kwargs):
        ctx = current_trace()
        params = {}
        for k, p in self._reg_params.items():
            value = ctx.params.get(p.name)
            if value is None:
                raise MXNetError("parameter %s missing from trace" % p.name)
            params[k] = value
        F = _F_SYM if ctx.symbolic else _F_TORCH
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def _build_symbolic(self, args, plist, key):
        """The symbolic route's CachedOp, or None when ``hybrid_forward``
        does not trace symbolically (shape reads, raw tensor math, ops
        outside the registry)."""
        from .. import graph as _graph
        from ..executor import build_plan
        from ..symbol import symbol as _sym
        try:
            in_names = ["in%d" % i for i in range(len(args))]
            in_syms = [None if a is None else _sym.Variable(n)
                       for n, a in zip(in_names, args)]
            param_syms = {}
            for p in plist:
                v = _sym.Variable(p.name)
                if p.grad_req == "null":
                    v._outputs[0][0].is_aux_var = True
                param_syms[p.name] = v
            with trace_scope(_TraceCtx(param_syms, True, symbolic=True)):
                out = self._call_traced(*in_syms)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            if not outs or not all(isinstance(o, _sym.Symbol)
                                   for o in outs):
                return None
            sym = _sym.Group(outs) if len(outs) > 1 else outs[0]
            opt_sym, report = _graph.optimize(sym)
        except Exception:  # noqa: BLE001
            # the reference's law: any block that does not trace with
            # Symbols (a shape read, tensor math, an op outside the
            # registry) takes the traced route instead
            return None
        self._cached_graph_report = report
        return _CachedOp(self, plist, key, build_plan(opt_sym, key[1]),
                         in_names)

    def _build_cached_op(self, args, plist=None):
        plist = plist if plist is not None else _ordered_params(self)
        key = (len(args), args[0]._device)
        from .. import graph as _graph
        op = self._build_symbolic(args, plist, key) \
            if _graph.enabled() else None
        return op if op is not None else _CachedOp(self, plist, key)

    def _call_cached(self, *args):
        plist = self._check_params(args)
        op = self._cached_op
        if op is None or op.key != (len(args), args[0]._device):
            op = self._cached_op = self._build_cached_op(args, plist)
        return op(args)

    def _call_raw(self, *args, **kwargs):
        plist = self._check_params(args)
        return _CachedOp(self, plist, None)(args, kwargs)

    # -- dispatch ----------------------------------------------------------
    def forward(self, *args, **kwargs):
        first = args[0] if args else None
        if isinstance(first, NDArray):
            # kwargs (a loss's sample_weight by name) bypass the CachedOp,
            # which is positional, as the reference's
            if self._active and not kwargs and not _eager_once():
                return self._call_cached(*args)
            return self._call_eager(*args, **kwargs)
        if current_trace() is not None:
            return self._call_traced(*args, **kwargs)
        return self._call_raw(*args, **kwargs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A Symbol and its parameters as a block (reference
    ``block.py:SymbolBlock``): arguments other than ``inputs`` become
    parameters (aux states with ``grad_req="null"``), their shapes inferred
    from the first input when not given.  The graph is rewritten by the
    pipeline and evaluated by the executor's plan, differentiably."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as sym_mod
        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        aux_names = set(outputs.list_auxiliary_states())

        def local(name):
            return name[len(self.params.prefix):] \
                if name.startswith(self.params.prefix) else name
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self.params.get(local(name), allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(local(name), grad_req="null",
                            allow_deferred_init=True)
        self._aux_names = aux_names

    def infer_shape(self, *args):
        shapes = {n: tuple(a.shape) for n, a in zip(self._input_names, args)}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        given = dict(zip(self._symbol.list_arguments(), arg_shapes))
        given.update(zip(self._symbol.list_auxiliary_states(), aux_shapes))
        for name, p in self.params.items():
            p.shape = tuple(given[name])

    def _finish_deferred_recursive(self, *args):
        self.infer_shape(*args)
        for p in self.params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def forward(self, *args):
        plist = self._check_params(args)
        device = args[0]._device if isinstance(args[0], NDArray) \
            else args[0].device
        op = self._cached_op
        if op is None or op.key != (len(args), device):
            from .. import graph as _graph
            from ..executor import build_plan
            sym, report = _graph.optimize(self._symbol) \
                if _graph.enabled() else (self._symbol, None)
            self._cached_graph_report = report
            op = self._cached_op = _CachedOp(
                self, plist, (len(args), device), build_plan(sym, device),
                self._input_names)
        return op(args)


def functionalize(net, *example_args, train=False):
    """A pure function of a HybridBlock over torch tensors (the torch
    meaning of exporting the reference's CachedOp): ``(apply_fn,
    params)``, ``apply_fn(params, *inputs, rng=None) -> (outputs,
    new_aux)``, ``params`` the current parameter tensors (differentiable
    ones first, then the aux ones) in the order ``apply_fn`` takes them.
    Gradients flow to whatever tensors are passed as ``params``; dropout
    draws from :mod:`mxnet_tpu_torch.random` (``rng`` is accepted for the
    reference's signature)."""
    nd_args = tuple(a if isinstance(a, NDArray) else NDArray(a)
                    for a in example_args)
    plist = net._check_params(nd_args)
    op = net._build_cached_op(nd_args, plist)
    device = nd_args[0]._device

    def apply_fn(params, *inputs, rng=None):
        outs, new_aux = op.run(list(inputs), list(params), train, device)
        return tuple(outs), tuple(new_aux)

    apply_fn.net = net          # the CachedOp holds the net weakly

    apply_fn.param_names = [p.name for p in plist]
    apply_fn.num_aux = sum(1 for p in plist if p.grad_req == "null")
    return apply_fn, [p.data()._data.detach() for p in plist]
