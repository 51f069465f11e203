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

``kvstore="device"`` (or ``"local"``/``None``) on one card means no
kvstore at all; the ``dist*`` kinds belong to the multi-device slice and
raise.
"""
from __future__ import annotations

from .. import optimizer as opt
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
        if kvstore not in ("device", "local", None):
            raise NotImplementedError(
                "kvstore %r: distributed kvstores belong to the "
                "multi-device slice of the port" % (kvstore,))
        self._params = list(params)
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
        self._fused.resolve()
        limit = max_consecutive_skips()
        if self._fused.streak >= limit:
            raise_skip_limit_error(limit)
        self._optimizer.rescale_grad = self._scale / batch_size
        # detached aliases of the leaves: the update writes their storage
        live = [(i, p.data()._data.detach(), p.grad()._data)
                for i, p in enumerate(self._params) if p.grad_req != "null"]
        if not self._fused_step(live):
            for i, weight, grad in live:
                self._updaters(i, grad, weight)

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
        fused.configure(keys, params)
        lr, wd, rescale, t = fused.begin()
        fused.finish(fused.guarded(
            params, {keys[i]: g for i, _, g in live}, fused.state, lr, wd,
            rescale, t))
        return True

    def _resolve_pending_verdict(self):
        """Apply the previous fused step's verdict (skip streak and clock
        rewind); the limit is checked at the top of :meth:`step`."""
        self._fused.resolve()

    def save_states(self, fname):
        """The optimizer state (the Updater's pickle, fused state flushed
        into it first), written atomically."""
        from ..base import atomic_write
        self._fused.flush()
        atomic_write(fname, self._updaters.get_states())

    def load_states(self, fname):
        self._fused.drop(flush=False)   # re-seeded from the loaded states
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
        self._fused.streak = 0
