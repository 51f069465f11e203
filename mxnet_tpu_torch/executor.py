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
  interpret mode runs it;
- while the profiler runs, ``forward``, ``backward`` and
  ``forward_backward`` each record one trace event of the reference's
  names (``executor_forward``, ``executor_backward``,
  ``executor_forward_backward``), synchronized on their outputs so the
  durations are device work, not launch time.

Over a context list (``mesh=``, a ``dp`` mesh of contexts from
``parallel.dp_mesh_from_ctx``; ``Module(context=[...])`` binds so), the
reference runs one SPMD program over the whole batch; here each context
is one replica, as MXNet's executor group had: the arguments named in
``batch_names`` are split evenly along their first axis (a batch that does
not divide raises ``MXNetError``), every replica runs the graph on its
slice with the parameters copied to its device (differentiably, so the
replicas' gradients sum into the one bound gradient), and the outputs are
concatenated back.  What the reference computes over the whole batch stays
whole: a training BatchNorm, alone or fused into its convolution
(``_fused_conv_bn_act``), takes its batch statistics over every replica's
slice (sync-BN, :func:`_sync_bn_body`: partial sums moved to the first
replica and summed, differentiably, the convolutions and the
normalization staying on each replica), and the moving statistics move
once.  Any other training node that updates aux states, a loss head with
``normalization`` ``"batch"`` or ``"valid"``, and a node that folds the
batch axis (a sum or mean over it; found at bind by
:func:`_batch_folding`) run once on the first replica's device over the
replicas' inputs concatenated, and their batch-shaped outputs are split
back.  ``cpu(i)`` replicas share torch's one CPU device; ``gpu(i)`` replicas are
distinct cards.  A ``monitor_all`` monitor sees each node's outputs
gathered onto the first replica.  ``partition_rules`` resolve each
array's spec (:meth:`param_spec`; storage stays whole on the first
replica), and :meth:`zero_specs` gives the ZeRO-1 specs of the fused
step's optimizer state (``MXTPU_ZERO=1``, ``optimizer.FusedUpdate``).

Not ported yet: ``ctx_group`` staging (the next slice), and the
reference's AOT cache of the fit step and its cost telemetry.  The
reference's per-program dispatch counter has no counterpart: a forward
here is one eager pass of kernel launches.
"""
from __future__ import annotations

import logging

import torch

from . import profiler as _profiler
from .base import MXNetError
from .ndarray.ndarray import NDArray, zeros

__all__ = ["Executor", "build_plan"]


class Executor:
    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states,
                 mesh=None, batch_names=None, dp_axis="dp",
                 partition_rules=None):
        self._symbol = symbol
        self._ctx = torch.device(ctx)
        self._mesh = mesh
        self._dp_axis = dp_axis
        self._partition_rules = partition_rules
        self._batch_names = frozenset(batch_names or ())
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
        self._replicas = None
        self._specs = {}
        if mesh is not None:
            self._build_specs()
        self._plan = build_plan(self._opt_symbol, self._ctx,
                                self._replicas, self._batch_names,
                                self._bound())

    # -- replicas and specs ------------------------------------------------
    def _build_specs(self):
        """Replicas of the mesh's ``dp`` axis, and every array's spec: batch
        arguments ``batch_spec`` (their first axis must divide), the rest by
        the partition rules (replicated when none matches)."""
        from .context import resolve_device
        from .parallel import sharding as _shd
        mesh, axis = self._mesh, self._dp_axis
        ndev = mesh.shape.get(axis, 1)
        if ndev > 1:
            self._replicas = [resolve_device(c) for c in mesh.devices.flat]
        batch, ruled = {}, {}
        for name, arr in list(self.arg_dict.items()) + \
                list(self.aux_dict.items()):
            if name in self._batch_names and arr.ndim >= 1:
                if arr.shape[0] % ndev:
                    raise MXNetError(
                        "batch axis of %r (shape %s) not divisible by the "
                        "%d-device data-parallel mesh" %
                        (name, tuple(arr.shape), ndev))
                batch[name] = _shd.batch_spec(arr.ndim, axis)
            else:
                ruled[name] = arr
        self._specs = _shd.match_partition_rules(
            self._partition_rules or [], ruled, mesh=mesh)
        self._specs.update(batch)

    def _bound(self):
        """{name: tensor} of every bound argument and aux state."""
        return {n: a.data for n, a in list(self.arg_dict.items()) +
                list(self.aux_dict.items())}

    def param_spec(self, name):
        """The bound PartitionSpec of ``name`` (P() when unsharded or
        without a mesh)."""
        from .parallel.sharding import P
        return self._specs.get(name, P())

    def zero_specs(self, update_names):
        """{name: PartitionSpec} of each updated parameter's optimizer
        state sharded 1/N over the ``dp`` replicas
        (``parallel.sharding.zero1_partition``), or None without a ``dp``
        axis of more than one replica."""
        if self._replicas is None:
            return None
        from .parallel.sharding import zero1_partition
        return zero1_partition(
            {n: self.arg_dict[n] for n in update_names}, self._mesh,
            axis=self._dp_axis,
            base_specs={n: self.param_spec(n) for n in update_names})

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
                else build_plan(self._symbol, self._ctx, self._replicas,
                                self._batch_names, self._bound())

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
        with _profiler._timed("executor_forward") as t:
            self._forward(is_train, kwargs)
            t.sync_arrays = [o.data for o in self.outputs]
        return self.outputs

    def _forward(self, is_train, kwargs):
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

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs, weighted by ``out_grads`` (ones by
        default), into ``grad_dict`` per ``grad_req``."""
        if all(r == "null" for r in self._grad_req.values()):
            return
        with _profiler._timed("executor_backward") as t:
            t.sync_arrays = self._backward(out_grads)

    def _backward(self, out_grads):
        """The body of :meth:`backward`; returns the gradients written."""
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
        written = []
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
            written.append(dst.data)
        return written

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
        program for both, and one profiler event); returns ``outputs``."""
        with _profiler._timed("executor_forward_backward") as t:
            self._forward(True, kwargs)
            grads = []
            if any(r != "null" for r in self._grad_req.values()):
                grads = self._backward(out_grads)
            t.sync_arrays = grads + [o.data for o in self.outputs]
        return self.outputs

    def make_fit_step(self, update_names, guarded_apply):
        """The fused train step of ``Module.fit``.

        ``update_names`` -- the ``grad_req="write"`` parameters the step
        updates; ``guarded_apply`` -- the guarded tree-wide update
        (``ops.optimizer_ops.make_guarded_apply``).

        Returns ``step(param_vals, state, other_vals, lr, wd, rescale, t,
        poison=0.0) -> (outs, ok)``: the training forward through the
        bound plan (aux states as bound), the gradients of every output
        (seeded with ones, as :meth:`backward`'s default) by
        ``torch.autograd.grad`` on the updated parameters, then the
        guarded update, which writes ``param_vals`` and ``state`` in place
        unless a gradient is non-finite (``poison``, added to every
        gradient, is NaN when the ``grad.nan`` fault site fires), and the
        new aux values only when it passed; ``ok`` is its verdict.  Nothing
        is written into ``grad_dict``.  The reference's step, one donated
        XLA program, takes and returns the optimizer state and aux values
        as well (``step(param_vals, opt_state, other_vals, aux_vals, lr, wd,
        rescale, t, poison) -> (outs, new_params, new_state, new_aux,
        ok)``); in place and eager, those are the same tensors."""
        update_names = tuple(update_names)

        def step(param_vals, state, other_vals, lr, wd, rescale, t,
                 poison=0.0):
            leaves = {n: param_vals[n].detach().requires_grad_()
                      for n in update_names}
            args = dict(other_vals)
            args.update(leaves)
            new_aux = {}
            with torch.enable_grad():
                outs = self._plan(args, self._raw_aux(), True,
                                  aux_out=new_aux)
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
                               grads, state, lr, wd, rescale, t, poison)
            # the guard's skip covers the aux states too: a skipped step
            # (a NaN batch poisons BatchNorm's moving statistics as well
            # as the gradients) commits none of them
            if isinstance(ok, bool):
                if ok:
                    self._write_aux(new_aux)
            else:
                old = self._raw_aux()
                self._write_aux({k: torch.where(ok, v.detach(), old[k])
                                 for k, v in new_aux.items()})
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
                        self._grad_req, new_aux, mesh=self._mesh,
                        batch_names=self._batch_names,
                        dp_axis=self._dp_axis,
                        partition_rules=self._partition_rules)


def _whole_batch(node, train):
    """Does the reference compute ``node`` over the whole batch in a way a
    replica's slice cannot: a training node updating aux states
    (BatchNorm's batch and moving statistics) or a loss head normalized
    by the batch or by its valid labels?"""
    if node.params.get("normalization") in ("batch", "valid"):
        return True
    return bool(train) and any(inp.is_var and inp.is_aux_var
                               for inp, _ in node.inputs)


def build_plan(symbol, device, replicas=None, batch_names=(), bound=None):
    """``plan(arg_vals, aux_vals, train, tap=None, aux_out=None) ->
    outs``: ``symbol``'s graph evaluated node by node on ``device``
    (:func:`~.graph.graph.apply_node` per node), the evaluator of an
    :class:`Executor` and of a hybridized Gluon block's graph.  A node's
    outputs are dropped after their last consumer runs, so an inference
    forward holds only the live activations (XLA frees the reference's
    buffers alike); a training forward keeps what autograd saved.  The new
    value an op returns for an aux input (``mutate_aux``) goes into
    ``aux_out`` under the aux variable's name.  With ``replicas`` (more
    than one device) the plan runs one replica a device, the arguments of
    ``batch_names`` split along their first axis, ``bound`` ({name:
    tensor} of the bound arrays) giving the shapes that find the nodes
    which fold the batch (:func:`_batch_folding`; see the module's
    docstring)."""
    if replicas is not None and len(replicas) > 1:
        return _replica_plan(symbol, list(replicas), frozenset(batch_names),
                             bound or {})
    from .graph.graph import apply_node
    nodes, heads, drop_after = _liveness(symbol)

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


def _liveness(symbol):
    """``(nodes, heads, drop_after)``: the topological nodes, the heads,
    and for each node the values whose last consumer it is (never a
    head's)."""
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
    return nodes, heads, drop_after


def _sync_bn_body(node, train):
    """The replicas' body of a training BatchNorm, alone or fused into its
    convolution (sync-BN: the statistics summed across the replicas, the
    convolutions and the normalization on each): ``body(parts)`` over one
    list of per-replica tensors an input, returning ``(outputs a replica,
    new_moving_mean, new_moving_var)``.  None for any other node, and for
    BatchNorm with global statistics or ``output_mean_var``."""
    if not train:
        return None
    p = {k: v for k, v in node.op.canon_params(dict(node.params)).items()
         if not k.startswith("_")}
    if p.get("use_global_stats"):
        return None
    if node.op.name == "BatchNorm" and not p.get("output_mean_var"):
        from .ops.nn import batch_norm_replicas
        return lambda parts: batch_norm_replicas(*parts, **p)
    if node.op.name == "_fused_conv_bn_act":
        from .ops.fused import conv_bn_act_replicas
        return lambda parts: conv_bn_act_replicas(
            parts[0], parts[1], list(zip(*parts[2:])), **p)
    return None


def _batch_folding(symbol, bound, batch_names, n_rep):
    """ids of the nodes that fold the batch, which a replica's slice
    cannot run.  The graph is walked on ``meta`` twice, at the bound batch
    and at one replica's slice of it: a node fed by the batch whose every
    output shrinks ``n_rep``-fold along its first axis is separable; one
    whose output keeps its shape (a sum or mean over the batch axis or over
    all axes) or shrinks elsewhere (a transpose or reshape across it) folds
    the batch, and so does a node whose body cannot run on ``meta``."""
    from .graph.graph import apply_node
    meta = torch.device("meta")
    folding = set()
    vals = {}   # id(node) -> [(whole, slice, split)], None: unknown

    def shrunk(t):
        return torch.empty((t.shape[0] // n_rep,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=meta)

    for node in symbol._topo_nodes():
        if node.is_var:
            a = bound.get(node.name)
            if a is None:
                vals[id(node)] = None
                continue
            t = torch.empty(a.shape, dtype=a.dtype, device=meta)
            split = not node.is_aux_var and node.name in batch_names and \
                t.dim() >= 1
            vals[id(node)] = [(t, shrunk(t) if split else t, split)]
            continue
        ins = [None if vals[id(inp)] is None else vals[id(inp)][idx]
               for inp, idx in node.inputs]
        if any(x is None for x in ins):
            folding.add(id(node))
            vals[id(node)] = None
            continue
        try:
            whole = apply_node(node, [w for w, _, _ in ins], True, meta)[0]
            if not any(s for _, _, s in ins):
                vals[id(node)] = [(o, o, False) for o in whole]
                continue
            part = apply_node(node, [p for _, p, _ in ins], True, meta)[0]
        except Exception:   # noqa: BLE001 - a body without a meta path
            folding.add(id(node))
            vals[id(node)] = None
            continue
        if all(w.dim() >= 1 and w.shape[0] % n_rep == 0 and
               w.shape[0] > p.shape[0] and p.shape == shrunk(w).shape
               for w, p in zip(whole, part)):
            vals[id(node)] = [(w, p, True) for w, p in zip(whole, part)]
            continue
        folding.add(id(node))
        # run whole, a batch-shaped output is split back (as at run time)
        batch = next(w for w, _, s in ins if s).shape[0]
        vals[id(node)] = [
            (w, shrunk(w), True) if w.dim() >= 1 and w.shape[0] == batch
            else (w, w, False) for w in whole]
    return folding


def _replica_plan(symbol, replicas, batch_names, bound):
    """The plan over replicas: each value is ``(split, parts)``, ``parts``
    one tensor a replica and ``split`` whether they are slices of the
    batch (else copies of one value); values die after their last
    consumer, as in :func:`build_plan`."""
    from .graph.graph import apply_node
    nodes, heads, drop_after = _liveness(symbol)
    first = replicas[0]
    n_rep = len(replicas)
    folding = _batch_folding(symbol, bound, batch_names, n_rep)

    def gather(split, parts):
        if not split:
            return parts[0]
        return torch.cat([p.to(first) for p in parts])

    def plan(arg_vals, aux_vals, train, tap=None, aux_out=None):
        vals = {}
        for i, node in enumerate(nodes):
            if node.is_var:
                if node.is_aux_var:
                    v, split = aux_vals[node.name], False
                else:
                    v = arg_vals[node.name]
                    split = node.name in batch_names and v.dim() >= 1
                parts = [c.to(d) for c, d in zip(torch.chunk(v, n_rep),
                                                 replicas)] if split \
                    else [v.to(d) for d in replicas]
                vals[id(node)] = [(split, parts)]
                continue
            ins = [vals[id(inp)][idx] for inp, idx in node.inputs]
            sync = _sync_bn_body(node, train) \
                if id(node) not in folding and ins[0][0] and \
                not any(s for s, _ in ins[1:]) else None
            if sync is not None:
                per, new_mm, new_mv = sync([p for _, p in ins])
                extra = [new_mm, new_mv]
                outs = [(True, [v[j] for v in per])
                        for j in range(len(per[0]))]
            elif (id(node) in folding or _whole_batch(node, train)) and \
                    any(s for s, _ in ins):
                # the node runs once over the whole batch on the first
                # replica, and its batch-shaped outputs are split back
                sizes = [p.shape[0] for p in next(p for s, p in ins if s)]
                vis, extra = apply_node(node, [gather(s, p) for s, p in ins],
                                        train, first)
                outs = []
                for o in vis:
                    if o.dim() >= 1 and o.shape[0] == sum(sizes):
                        outs.append((True, [c.to(d) for c, d in zip(
                            torch.split(o, sizes), replicas)]))
                    else:
                        outs.append((False, [o.to(d) for d in replicas]))
            else:
                split = any(s for s, _ in ins)
                per = [apply_node(node, [p[r] for _, p in ins], train, d)
                       for r, d in enumerate(replicas)]
                extra = per[0][1]
                outs = [(split, [v[0][j] for v in per])
                        for j in range(len(per[0][0]))]
            if extra and aux_out is not None:
                for (inp, _), new in zip(node.inputs[-len(extra):], extra):
                    if inp.is_var and inp.is_aux_var:
                        aux_out[inp.name] = new.to(first)
            vals[id(node)] = outs
            del ins
            if tap is not None:
                tap(node, [gather(s, p) for s, p in outs])
            for dead in drop_after[i]:
                del vals[dead]
        return [gather(*vals[id(n)][i]) for n, i in heads]

    return plan
