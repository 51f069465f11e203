"""Executor: a bound symbolic graph (counterpart of ``mxnet_tpu/executor.py``).

At bind, the graph rewrite pipeline (:mod:`.graph`) rewrites the symbol
once; every forward and backward evaluates the REWRITTEN graph node by
node with torch ops and the package's kernels.  What the reference's jit
programs become here:

- ``forward(is_train=False)`` runs the plan under ``torch.no_grad()``;
- a training forward (``is_train=True`` with any ``grad_req`` not
  ``null``) marks those arguments as requiring grad and keeps torch's
  graph: the torch meaning of the vjp residuals the reference keeps;
- ``backward(out_grads)`` applies that graph with the given head
  gradients (ones by default) and writes or adds into ``grad_dict`` per
  ``grad_req``; without a preceding training forward it reruns the
  forward first, as the reference's fused program does;
- aux states are bound and read by name; the new values an op returns
  for them (BatchNorm's moving statistics while training) are written
  back into ``aux_dict`` after the forward, as the reference's
  ``mutate_aux`` contract does;
- :meth:`make_fit_step` is the fused train step of ``Module.fit``: one
  eager pass of the training forward, ``torch.autograd.grad`` on the
  updated parameters and the guarded multi-tensor optimizer update, in
  place (the reference traces all three into one donated XLA program);
- a monitor installed with ``monitor_all`` taps every node's output of
  the user's (unrewritten) graph, run node by node as the reference's
  interpret mode runs it.

Not ported yet: mesh/SPMD placement and ``ctx_group`` staging (the
multi-device slice), and the reference's ZeRO placements, AOT cache of
the fit step and its cost telemetry.  The reference's per-program
dispatch counter has no counterpart: a forward here is one eager pass of
kernel launches.
"""
from __future__ import annotations

import logging

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray, zeros

__all__ = ["Executor", "build_plan"]


class Executor:
    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states):
        self._symbol = symbol
        self._ctx = torch.device(ctx)
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad) if args_grad else {}
        self.aux_dict = dict(aux_states) if aux_states else {}
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._monitor_callback = None
        self._monitor_all = False
        self._interp_plan = None
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self._grad_req = dict(grad_req or {})
        for n in self._arg_names:
            self._grad_req.setdefault(n, "null")
            if self._grad_req[n] not in ("write", "add", "null"):
                raise MXNetError("grad_req must be write, add or null, got "
                                 "%r for %s" % (self._grad_req[n], n))
            if self._grad_req[n] != "null" and n not in self.grad_dict:
                a = self.arg_dict.get(n)
                if a is not None:
                    self.grad_dict[n] = NDArray(torch.zeros_like(a.data),
                                                self._ctx)
        self.outputs = []
        self._saved = None
        # graph rewrite pipeline: the compiler stage between bind and the
        # first forward.  A pass failure falls back to the unrewritten
        # graph (logged): the pipeline may only make a bind faster, never
        # break it.  No kernel runs inside a pass.
        self._opt_symbol = symbol
        self._graph_report = None
        from . import graph as _graph
        if _graph.enabled():
            try:
                self._opt_symbol, self._graph_report = \
                    _graph.optimize(symbol)
            except Exception as e:
                logging.warning(
                    "mxnet_tpu_torch.executor: graph rewrite pipeline "
                    "failed (%s: %s); running the unrewritten graph",
                    type(e).__name__, e)
                self._opt_symbol = symbol
        self._plan = build_plan(self._opt_symbol, self._ctx)

    def _diff_names(self):
        return [n for n in self._arg_names
                if self._grad_req[n] != "null" and n in self.arg_dict]

    def _raw_aux(self):
        return {k: v.data for k, v in self.aux_dict.items()}

    def _write_aux(self, new_aux):
        for name, value in new_aux.items():
            self.aux_dict[name]._assign(value.detach())

    def _train_forward(self):
        """The training forward with torch's graph kept: ``(outs,
        leaves)``, ``leaves`` the differentiable arguments (views of the
        bound arrays' storage that require grad)."""
        leaves = {n: self.arg_dict[n].data.detach().requires_grad_()
                  for n in self._diff_names()}
        args = {k: leaves.get(k, v.data) for k, v in self.arg_dict.items()}
        with torch.enable_grad():
            outs = self._run(args, True)
        return outs, leaves

    def _run(self, args, train):
        """The plan on ``args``; under a ``monitor_all`` monitor, the
        user's unrewritten graph node by node with every node's outputs
        handed to the callback (the reference's interpret mode)."""
        if self._monitor_callback is None or not self._monitor_all:
            new_aux = {}
            outs = self._plan(args, self._raw_aux(), train, aux_out=new_aux)
            self._write_aux(new_aux)
            return outs
        if self._interp_plan is None:
            self._interp_plan = self._plan \
                if self._opt_symbol is self._symbol \
                else build_plan(self._symbol, self._ctx)

        def tap(node, vis):
            for j, v in enumerate(vis):
                suffix = "_output" if len(vis) == 1 else "_output%d" % j
                self._monitor_callback(node.name + suffix,
                                       NDArray(v.detach(), self._ctx))
        return self._interp_plan(args, self._raw_aux(), train, tap=tap)

    # -- execution ---------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` name arguments to copy in first (numpy
        arrays, tensors or NDArrays, cast to the bound dtype).  Returns
        ``outputs``."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %s" % k)
            self.arg_dict[k][:] = v
        self._saved = None
        if is_train and self._diff_names():
            # a training forward keeps its graph for backward()
            outs, leaves = self._train_forward()
            self._saved = (outs, leaves)
        else:
            args = {k: v.data for k, v in self.arg_dict.items()}
            with torch.no_grad():
                outs = self._run(args, bool(is_train))
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        if self._monitor_callback is not None and not self._monitor_all:
            for name, arr in zip(self._output_names, self.outputs):
                self._monitor_callback(name, arr)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs, weighted by ``out_grads`` (ones by
        default), into ``grad_dict`` per ``grad_req``."""
        if all(r == "null" for r in self._grad_req.values()):
            return
        if self._saved is None:
            # no training forward kept its graph: run one now
            outs, leaves = self._train_forward()
            self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        else:
            outs, leaves = self._saved
        self._saved = None
        if out_grads is None:
            ograds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            ograds = [g.data if isinstance(g, NDArray)
                      else torch.as_tensor(g, device=self._ctx)
                      for g in out_grads]
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, ograds)
                 if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [g for _, g in pairs], allow_unused=True)
        for name, g in zip(names, grads):
            dst = self.grad_dict.get(name)
            if dst is None:
                continue
            if g is None:       # no path from the outputs: a zero gradient
                g = torch.zeros_like(leaves[name])
            if self._grad_req[name] == "add":
                dst._set_data(dst.data + g)
            else:
                dst._set_data(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameters by name into the bound arrays (numpy arrays,
        tensors or NDArrays; a JAX executor's ``arg_dict`` as numpy carries
        over as it is: the names are the same).  An unknown name raises
        unless ``allow_extra_params``."""
        for dst, src, kind in ((self.arg_dict, arg_params, "argument"),
                               (self.aux_dict, aux_params or {}, "aux")):
            for name, value in src.items():
                if name in dst:
                    dst[name][:] = value.data if isinstance(
                        value, NDArray) else value
                elif not allow_extra_params:
                    raise MXNetError("found name %r that is not in the %ss"
                                     % (name, kind))

    def forward_backward(self, out_grads=None, **kwargs):
        """A training forward then :meth:`backward` (the reference's one
        program for both); returns ``outputs``."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    def make_fit_step(self, update_names, guarded_apply):
        """The fused train step of ``Module.fit``.

        ``update_names`` -- the ``grad_req="write"`` parameters the step
        updates; ``guarded_apply`` -- the guarded tree-wide update
        (``ops.optimizer_ops.make_guarded_apply``).

        Returns ``step(param_vals, state, other_vals, lr, wd, rescale, t)
        -> (outs, ok)``: the training forward through the bound plan (aux
        states as bound), the gradients of every output (seeded with ones,
        as :meth:`backward`'s default) by ``torch.autograd.grad`` on the
        updated parameters, then the guarded update, which writes
        ``param_vals`` and ``state`` in place unless a gradient is
        non-finite; ``ok`` is its verdict.  Nothing is written into
        ``grad_dict``.  The reference's step, one donated XLA program,
        takes and returns the optimizer state and aux values as well
        (``step(param_vals, opt_state, other_vals, aux_vals, lr, wd,
        rescale, t, poison) -> (outs, new_params, new_state, new_aux,
        ok)``); in place and eager, those are the same tensors."""
        update_names = tuple(update_names)

        def step(param_vals, state, other_vals, lr, wd, rescale, t):
            leaves = {n: param_vals[n].detach().requires_grad_()
                      for n in update_names}
            args = dict(other_vals)
            args.update(leaves)
            new_aux = {}
            with torch.enable_grad():
                outs = self._plan(args, self._raw_aux(), True,
                                  aux_out=new_aux)
            self._write_aux(new_aux)
            heads = [o for o in outs if o.requires_grad]
            grads = torch.autograd.grad(
                heads, [leaves[n] for n in update_names],
                [torch.ones_like(o) for o in heads], allow_unused=True) \
                if heads else [None] * len(update_names)
            grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                     for n, g in zip(update_names, grads)}
            outs = [o.detach() for o in outs]
            del heads, leaves
            ok = guarded_apply({n: param_vals[n] for n in update_names},
                               grads, state, lr, wd, rescale, t)
            return outs, ok

        return step

    # -- parameter management ----------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` on the outputs of every forward;
        with ``monitor_all`` on every node's outputs (slow: the user's
        graph node by node)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for the shapes in ``kwargs``: arrays whose shape
        did not change are shared, the others start at zeros."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def kept(cur, shape):
            return cur if cur.shape == tuple(shape) else \
                zeros(shape, ctx=self._ctx, dtype=cur.dtype)
        new_args = {n: kept(self.arg_dict[n], s)
                    for n, s in zip(self._arg_names, arg_shapes)}
        new_aux = {n: kept(self.aux_dict[n], s)
                   for n, s in zip(self._aux_names, aux_shapes)}
        args_grad = {n: zeros(a.shape, ctx=self._ctx, dtype=a.dtype)
                     for n, a in new_args.items()
                     if self._grad_req.get(n, "null") != "null"}
        return Executor(self._symbol, self._ctx, new_args, args_grad,
                        self._grad_req, new_aux)


def build_plan(symbol, device):
    """``plan(arg_vals, aux_vals, train, tap=None, aux_out=None) ->
    outs``: ``symbol``'s graph evaluated node by node on ``device``
    (:func:`~.graph.graph.apply_node` per node), the evaluator of an
    :class:`Executor` and of a hybridized Gluon block's graph.  A node's
    outputs are dropped after their last consumer runs, so an inference
    forward holds only the live activations (XLA frees the reference's
    buffers alike); a training forward keeps what autograd saved.  The new
    value an op returns for an aux input (``mutate_aux``) goes into
    ``aux_out`` under the aux variable's name."""
    from .graph.graph import apply_node
    nodes = symbol._topo_nodes()
    heads = list(symbol._outputs)
    last_use = {}
    for i, node in enumerate(nodes):
        for inp, _ in node.inputs:
            last_use[id(inp)] = i
    keep = {id(n) for n, _ in heads}
    drop_after = [[] for _ in nodes]
    for node in nodes:
        if id(node) in last_use and id(node) not in keep:
            drop_after[last_use[id(node)]].append(id(node))

    def plan(arg_vals, aux_vals, train, tap=None, aux_out=None):
        vals = {}
        for i, node in enumerate(nodes):
            if node.is_var:
                vals[id(node)] = [aux_vals[node.name] if node.is_aux_var
                                  else arg_vals[node.name]]
                continue
            inputs = [vals[id(inp)][idx] for inp, idx in node.inputs]
            vals[id(node)], extra = apply_node(node, inputs, train, device)
            if extra and aux_out is not None:
                # trailing inputs are the aux states, one to one
                for (inp, _), new in zip(node.inputs[-len(extra):], extra):
                    if inp.is_var and inp.is_aux_var:
                        aux_out[inp.name] = new
            del inputs
            if tap is not None:
                tap(node, vals[id(node)])
            for dead in drop_after[i]:
                del vals[dead]
        return [vals[id(n)][i] for n, i in heads]

    return plan
