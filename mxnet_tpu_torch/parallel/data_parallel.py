"""Data-parallel train steps on ``torch.func`` (counterpart of
``mxnet_tpu/parallel/data_parallel.py``).

The reference jits one SPMD program whose batch is sharded over ``dp``
and lets XLA insert the gradient psum.  The torch meaning, one rank a
member of the ``dp`` axis: each rank takes its shard of the batch
(:func:`~.sharding.batch_spec`), ``torch.func.grad_and_value`` of the pure
``loss_fn(params, batch, rng)`` on it, then one all-reduce of the
gradients (and the loss) over the ``dp`` group, averaged, and the
optimizer update.  ``loss_fn`` is a mean over its batch, so the average of
the shards' gradients is the gradient of the whole batch (the reference's
result, exactly when the shards are equal in size).  In a job of one
process the step is the plain step on the whole batch.
"""
from __future__ import annotations

import functools

import torch

from .mesh import AXIS_DP
from . import sharding as shd


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def sgd_momentum_init(params):
    return {"mom": {k: torch.zeros_like(v) for k, v in params.items()}}


def sgd_momentum_apply(params, grads, state, lr=0.01, momentum=0.9, wd=0.0):
    """The reference's ``sgd_mom_update``: ``mom = m*mom - lr*(g + wd*w);
    w += mom``."""
    new_p, new_m = {}, {}
    for k, w in params.items():
        g = grads[k] + wd * w
        m = momentum * state["mom"][k] - lr * g
        new_p[k] = w + m
        new_m[k] = m
    return new_p, {"mom": new_m}


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def make_train_step(loss_fn, mesh, optimizer_apply=None, optimizer_init=None,
                    param_rules=None, dp_axis=AXIS_DP, donate=True,
                    batch_ndims=None):
    """Build ``(init_fn, step_fn)``.

    ``loss_fn(params, batch, rng) -> scalar``: pure, a mean over the
    batch; ``batch`` a tree (dict, tuple, tensor) of arrays with a leading
    batch dim.  ``param_rules`` place the parameters
    (:func:`~.sharding.shard_params`), replicated by default.
    ``optimizer_apply(params, grads, state) -> (params, state)``: default
    SGD with momentum 0.9 at lr 0.01.  ``donate`` is accepted for the
    reference's signature (eager tensors have nothing to donate).

    Returns ``init_fn(params) -> (params, opt_state)`` and
    ``step_fn(params, opt_state, batch, rng) -> (params, opt_state,
    loss)``; the loss is the mean over the ``dp`` ranks.
    """
    optimizer_apply = optimizer_apply or functools.partial(
        sgd_momentum_apply, lr=0.01, momentum=0.9)
    optimizer_init = optimizer_init or sgd_momentum_init
    rules = param_rules or []
    grad_and_value = torch.func.grad_and_value(loss_fn)

    def init_fn(params):
        params = {k: _as_tensor(v) for k, v in params.items()}
        params = shd.shard_params(params, mesh, rules)
        return params, optimizer_init(params)

    def local_batch(batch):
        return _tree_map(
            lambda b: shd.local_shard(_as_tensor(b),
                                      shd.batch_spec(_as_tensor(b).dim(),
                                                     dp_axis), mesh),
            batch)

    def step_fn(params, opt_state, batch, rng):
        from . import collectives as col
        grads, loss = grad_and_value(params, local_batch(batch), rng)
        if dp_axis in mesh.shape and mesh.shape[dp_axis] > 1:
            names = list(grads)
            flat = torch.cat([grads[n].reshape(-1) for n in names] +
                             [loss.detach().reshape(1).to(
                                 grads[names[0]].dtype)])
            flat = col.allreduce(flat, dp_axis, op="mean", mesh=mesh)
            off = 0
            for n in names:
                k = grads[n].numel()
                grads[n] = flat[off:off + k].view_as(grads[n])
                off += k
            loss = flat[off]
        new_params, new_state = optimizer_apply(params, grads, opt_state)
        return new_params, new_state, loss.detach()

    return init_fn, step_fn


class DataParallelTrainer:
    """Stateful convenience wrapper over :func:`make_train_step`."""

    def __init__(self, loss_fn, mesh, params, optimizer_apply=None,
                 optimizer_init=None, param_rules=None):
        self._init, self._step = make_train_step(
            loss_fn, mesh, optimizer_apply=optimizer_apply,
            optimizer_init=optimizer_init, param_rules=param_rules)
        self.params, self.opt_state = self._init(params)
        self.mesh = mesh

    def step(self, batch, rng):
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, batch, rng)
        return loss
