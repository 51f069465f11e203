"""Model helpers shared by the Module (counterpart of
``mxnet_tpu/model.py``): the kvstore decision, the per-parameter update
loop of the split path, and the two-file checkpoint ``prefix-symbol.json``
+ ``prefix-%04d.params`` with ``arg:``/``aux:`` key prefixes, which either
package loads from the other.

Each file is written atomically (a temporary file renamed over the
final path).  The reference's ``CheckpointManager`` (a manifest that
commits an epoch last, retention, async writes) comes with
``checkpoint.py`` in slice S4; kvstores come with slice S5.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .context import cpu

__all__ = ["BatchEndParam", "FeedForward", "save_checkpoint",
           "load_checkpoint", "load_params"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` (reference ``model.py:27``): one
    device and no ``dist`` kvstore needs no kvstore at all; every other
    case raises until the port's kvstore exists."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return (None, False)
    raise NotImplementedError(
        "kvstore %r on %d device(s): kvstores come with the multi-device "
        "slice of the port (queue A item 7, S5)" % (kvstore, num_device))


def _update_params(param_arrays, grad_arrays, updater, num_device):
    """Update each parameter with a gradient through ``updater`` (reference
    ``model.py:117``, without its kvstore aggregation: slice S5)."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (reference
    ``model.py:340``), each atomically."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_params(prefix, epoch):
    """``(arg_params, aux_params)`` from ``prefix-%04d.params``, as host
    arrays."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("unknown param prefix in %s" % k)
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (reference ``model.py:379``)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return (symbol, arg_params, aux_params)


class FeedForward(object):
    """Deprecated legacy model API (reference ``model.py:FeedForward``),
    kept for scripts; it delegates to :class:`~mxnet_tpu_torch.module.
    Module`, as MXNet's documentation advises.  ``ctx`` None is the
    current context (the card, or a ``with mx.Context`` scope's)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        import warnings
        warnings.warn("FeedForward is deprecated. Please use Module "
                      "instead.", DeprecationWarning)
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _init_iter(self, X, y, is_train):
        from .io import NDArrayIter, DataIter
        if isinstance(X, DataIter):
            return X
        X = X.asnumpy() if isinstance(X, nd.NDArray) else _np.asarray(X)
        if y is not None:
            y = y.asnumpy() if isinstance(y, nd.NDArray) else _np.asarray(y)
        elif is_train:
            raise ValueError("y must be specified when X is numpy.ndarray")
        if y is None:
            y = _np.zeros(X.shape[0], dtype=_np.float32)
        batch_size = min(self.numpy_batch_size, X.shape[0])
        return NDArrayIter(X, y, batch_size=batch_size,
                           shuffle=is_train, last_batch_handle="roll_over"
                           if is_train else "pad")

    def _make_module(self, data_iter):
        from .module import Module
        mod = Module(self.symbol,
                     data_names=[d.name for d in data_iter.provide_data],
                     label_names=[l.name for l in
                                  (data_iter.provide_label or [])],
                     context=self.ctx)
        self._module = mod
        return mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train (reference model.py:FeedForward.fit)."""
        data = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            ex, ey = eval_data
            eval_data = self._init_iter(ex, ey, is_train=False)
        mod = self._make_module(data)
        opt_params = {k: v for k, v in self.kwargs.items()}
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=opt_params,
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=True, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch if self.num_epoch else 1,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Forward over X; returns numpy outputs (reference
        model.py:FeedForward.predict)."""
        data = self._init_iter(X, None, is_train=False)
        if reset:
            data.reset()
        if self._module is None or not self._module.binded:
            mod = self._make_module(data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            if self.arg_params is not None:
                mod.set_params(self.arg_params, self.aux_params or {},
                               allow_missing=False)
            else:
                mod.init_params(self.initializer)
        outs = self._module.predict(data, num_batch=num_batch)
        if isinstance(outs, (list, tuple)):
            res = [o.asnumpy() for o in outs]
        else:
            res = outs.asnumpy()
        if return_data:
            return res, data
        return res

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Evaluate (reference model.py:FeedForward.score)."""
        from . import metric as metric_mod
        data = self._init_iter(X, None, is_train=False)
        if reset:
            data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        assert self._module is not None, "call fit before score"
        res = self._module.score(data, eval_metric, num_batch=num_batch)
        return dict(res).get(eval_metric.name, list(dict(res).values())[0])

    def save(self, prefix, epoch=None):
        """save_checkpoint with this model's params (reference :340)."""
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """Load a saved FeedForward (reference model.py:FeedForward.load)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct + fit in one call (reference model.py:FeedForward
        .create)."""
        if initializer is None:
            from .initializer import Uniform
            initializer = Uniform(0.01)
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
