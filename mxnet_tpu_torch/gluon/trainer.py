"""Gluon Trainer (the reference's ``mxnet_tpu/gluon/trainer.py``).

``Trainer(params, optimizer, optimizer_params)`` applies an
:class:`~mxnet_tpu_torch.optimizer.Optimizer` to the parameters of a
block, as the Gluon loop drives it::

    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-4})
    with autograd.record():
        loss = loss_fn(net(x), y).mean()
    loss.backward()
    trainer.step(batch_size)

``params`` is a :class:`~.parameter.ParameterDict` (``collect_params()``)
or a list of :class:`~.parameter.Parameter`; the Trainer reads each one's
gradient buffer (``param.grad()``), skips ``grad_req="null"`` ones, and
updates ``param.data()`` in place.  Laws of the reference, with their
torch meaning:

- SGD, SGD with momentum and Adam update every parameter as ONE
  multi-tensor update (``ops.optimizer_ops.make_fused_apply``,
  ``torch._foreach_*`` over the parameter list, held with its state by
  :class:`~mxnet_tpu_torch.optimizer.FusedUpdate`, as ``Module.fit_step``
  holds it) where the reference runs one donated XLA program over the
  parameter tree; other optimizers keep
  the per-parameter loop through an :class:`~mxnet_tpu_torch.optimizer.
  Updater`.  State moves between the two forms when the path changes.
- The fused update runs under the divergence guard
  (``make_guarded_apply``): when any gradient, after ``rescale_grad`` and
  clipping, is NaN or Inf, every parameter and optimizer state stays bit
  for bit as it was and the optimizer clocks rewind.  The verdict is a
  device scalar read one step late (at the top of the next ``step``, or
  when state is saved or handed over), so ``step`` never waits for the
  device; after ``MXTPU_MAX_CONSECUTIVE_SKIPS`` consecutive skips the next
  ``step`` raises ``MXNetError``.
- A step uses whatever the gradient buffers hold and leaves them as they
  are: ``param.grad()`` after ``step`` is the last backward's gradient,
  and the next backward overwrites it (``grad_req="write"``) or adds to
  it (``"add"``), as in the reference, whose Trainer clears nothing and
  does not check for stale gradients (``ignore_stale_grad`` is accepted
  for its signature).

- The reference's planes, at the same places and names: ``step`` fires
  the ``worker.stall`` site, raises a failed background checkpoint
  write, renews the ``trainer_step`` lease (the watchdog arms itself at
  the first renewal when ``MXTPU_STALL_TIMEOUT`` is set; call
  ``watchdog.disarm()`` after the last step if the process goes on to
  other work); the fused update takes the ``grad.nan`` poison, counts
  one dispatch, marks ``profiler.note_step()`` and records a
  ``trainer_step`` flight record (its launch window; the verdict is
  back-filled when it is read).  ``save_states`` writes the checksummed
  frame through ``checkpoint.async_write_state_file`` (on the writer
  thread under ``MXTPU_ASYNC_CKPT``: the payload is host bytes when
  ``save_states`` returns) and ``load_states`` reads it validated.

``kvstore="device"`` (or ``"local"``/``None``) on one card means no
kvstore at all (the fused update above).  A ``KVStore`` instance
(``mx.kv.create("local")``) is used as given, through
``model._create_kvstore`` as in the reference: at the first ``step`` each
parameter's weight is stored under its index and the optimizer is set on
the store (``update_on_kvstore``), then every step pushes each gradient
and pulls the updated weight back; ``save_states``/``load_states`` go
through the store's optimizer states.

``kvstore="dist_sync"`` (any ``dist*`` kind) joins the job's process
group (``kv.create``) and updates on the store: each step pushes every
live gradient in ONE push (one bucketed all-reduce over the workers,
``compression_params`` quantizing it as ``set_gradient_compression``
does) and pulls every updated weight back, so the workers' weights stay
bitwise equal.  Parameters initialized on a context list carry one
gradient summed over their replicas (``parameter.py``); under
``MXTPU_ZERO=1``, where every live parameter is on the same list of more
than one context, the fused update shards its state 1/N over those
replicas (``optimizer.FusedUpdate``; the reference's ``trainer.py:155``).
"""
from __future__ import annotations

import time

from .. import fault as _fault
from .. import optimizer as opt
from .. import profiler as _profiler
from .. import telemetry as _telemetry
from .. import watchdog as _watchdog
from ..model import _create_kvstore
from ..ops.optimizer_ops import max_consecutive_skips, raise_skip_limit_error
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
        self._params = list(params)
        self._compression_params = compression_params
        self._names = [p.name for p in self._params]
        optimizer_params = dict(optimizer_params or {})
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(
                optimizer, param_idx2name=dict(enumerate(self._names)),
                **optimizer_params)
        # a Parameter's own multipliers, keyed by index as Gluon keys them
        self._optimizer.set_lr_mult(
            {i: p.lr_mult for i, p in enumerate(self._params)})
        self._optimizer.set_wd_mult(
            {i: p.wd_mult for i, p in enumerate(self._params)})
        self._updaters = opt.get_updater(self._optimizer)
        # the fused update and its state; the verdict is read a step late
        self._fused = opt.FusedUpdate(self._optimizer, self._updaters,
                                      defer_verdict=True)
        self._kvstore = kvstore
        self._kv_initialized = False
        self._kv = None
        self._update_on_kvstore = False

    def _init_kvstore(self):
        """The store of ``kvstore`` (``model._create_kvstore`` on one
        device): each live parameter's weight under its index, and the
        optimizer on the store when it updates there."""
        arg_arrays = {p.name: p.data() for p in self._params
                      if p.grad_req != "null"}
        self._kv, self._update_on_kvstore = _create_kvstore(
            self._kvstore, 1, arg_arrays)
        if self._kv is not None:
            if self._compression_params:
                self._kv.set_gradient_compression(self._compression_params)
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kv.init(i, p.data())
            if self._update_on_kvstore:
                self._kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def _consec_guard_skips(self):
        return self._fused.streak

    def set_precision(self, policy):
        """Install a :class:`~mxnet_tpu_torch.precision.PrecisionPolicy`
        (or None): its fingerprint keys the fused update, its loss
        scaler's ``1 / scale`` joins ``rescale_grad`` and consumes the
        (one step late) guard verdict."""
        self._fused.resolve()
        self._fused.precision = policy

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step over every parameter whose ``grad_req`` is
        not ``null``, with gradients scaled by ``1 / batch_size``."""
        from ..checkpoint import check_async_error
        _fault.stall_if("worker.stall")
        # a failed background save_states write surfaces on the next step
        check_async_error()
        self._fused.resolve()
        limit = max_consecutive_skips()
        if self._fused.streak >= limit:
            raise_skip_limit_error(limit)
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        # detached aliases of the leaves: the update writes their storage
        live = [(i, p.data()._data.detach(), p.grad()._data)
                for i, p in enumerate(self._params) if p.grad_req != "null"]
        try:
            if self._kv is not None:
                self._kv_step()
            elif not self._fused_step(live):
                for i, weight, grad in live:
                    self._updaters(i, grad, weight)
        finally:
            # the progress lease, fused and per-parameter paths alike
            _watchdog.renew("trainer_step", phase="train")

    def _kv_step(self):
        """Push every live gradient, then pull every weight the store
        updated, each as one call over the keys (one all-reduce a step on
        a ``dist*`` store; the per-key sums are the reference's per-key
        pushes').  The Trainer holds a store only with
        ``update_on_kvstore`` (``model._create_kvstore``)."""
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not live:
            return
        keys = [i for i, _ in live]
        self._kv.push(keys, [p.list_grad() for _, p in live])
        self._kv.pull(keys, [p.list_data() for _, p in live])

    # -- fused multi-tensor step -------------------------------------------
    def _fused_step(self, live):
        """Update ``live`` (``(index, weight, grad)``) as one guarded
        multi-tensor update.  Returns False when the configuration cannot
        fuse (the caller then runs the per-parameter loop, which starts
        from the fused state)."""
        fused = self._fused
        if self._optimizer.fused_kind() is None or \
                len({id(self._params[i]) for i, _, _ in live}) != len(live):
            fused.drop()
            return False
        if not live:
            return True
        keys = {i: str(i) for i, _, _ in live}
        params = {keys[i]: w for i, w, _ in live}
        replicas, zero = self._zero_layout(live, params)
        fused.configure(keys, params, replicas=replicas, zero_specs=zero)
        poison = float("nan") if _fault.trigger("grad.nan") else 0.0
        lr, wd, rescale, t = fused.begin()
        t0 = time.perf_counter_ns()
        ok = fused.guarded(params, {keys[i]: g for i, _, g in live},
                           fused.state, lr, wd, rescale, t, poison)
        t1 = time.perf_counter_ns()
        _profiler.count_dispatch()
        _profiler.note_step()
        # no sync stamp and a pending verdict: both resolve a step late
        # (handle_guard_verdict back-fills the record)
        _telemetry.note_train_step(t0, t1, None, None, None, "trainer_step")
        fused.finish(ok)
        return True

    def _zero_layout(self, live, params):
        """``(replicas, zero specs)``: the devices of the one context list
        every live parameter was initialized on (None otherwise) and, under
        ``MXTPU_ZERO=1``, each parameter's ZeRO-1 spec over them."""
        lists = {tuple(self._params[i]._ctx_list or ()) for i, _, _ in live}
        if len(lists) != 1 or len(next(iter(lists))) < 2:
            return None, None
        from ..context import resolve_device
        from ..ops.optimizer_ops import zero_stage
        from ..parallel.mesh import dp_mesh_from_ctx
        ctxs = list(next(iter(lists)))
        replicas = [resolve_device(c) for c in ctxs]
        if zero_stage() < 1:
            return replicas, None
        from ..parallel.sharding import zero1_spec
        mesh = dp_mesh_from_ctx(ctxs)
        return replicas, {str(i): zero1_spec(w.shape, mesh,
                                             name=self._params[i].name)
                          for i, w, _ in live}

    def _resolve_pending_verdict(self):
        """Apply the previous fused step's verdict (skip streak and clock
        rewind); the limit is checked at the top of :meth:`step`."""
        self._fused.resolve()

    def save_states(self, fname):
        """Atomic, checksummed write (``checkpoint.write_state_file``'s
        frame).  Under ``MXTPU_ASYNC_CKPT=1`` the framed payload is host
        bytes when this returns, and the fsync and rename run on the
        async writer thread; failures surface on the next ``step``."""
        from ..checkpoint import async_write_state_file
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kv.save_optimizer_states(fname, dump_optimizer=True)
            return
        self._fused.flush()
        async_write_state_file(fname, self._updaters.get_states())

    def load_states(self, fname):
        """Validated read: a corrupt state file raises ``MXNetError``
        naming the path."""
        from ..checkpoint import flush_async, load_state_file
        # settle the pending verdict against the old state, and never
        # race the async writer over the same file
        self._fused.resolve()
        flush_async(raise_errors=False)
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kv.load_optimizer_states(fname)
            self._optimizer = self._kv._optimizer
            self._fused.streak = 0
            return
        self._fused.drop(flush=False)   # re-seeded from the loaded states
        load_state_file(fname, self._updaters.set_states)
        self._fused.streak = 0
