"""Parameter-free modules implemented in Python (the PyTorch package's
copy of ``mxnet_tpu/module/python_module.py``): ``PythonModule`` and
``PythonLossModule``, BaseModule subclasses with no parameters of their
own that splice host-side computation (custom losses, metric bridges)
into a SequentialModule chain.  The loss head's gradient lands on its
scores' device.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Module with no parameters: subclasses implement forward/backward;
    every parameter-related API is a documented no-op."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._output_names = list(output_names or [])
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- symbol/io info ----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters: none --------------------------------------------------
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes:
            eval_metric.update(labels, self.get_outputs())

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert len(data_shapes) == len(self._data_names)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Subclasses define outputs from self._data_shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """Head module computing a loss in Python: forward passes data
    through (so predictions remain visible), backward emits the gradient
    of the chosen loss w.r.t. its input (reference python_module.py:240).
    """

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names=data_names, label_names=label_names,
                         output_names=[name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss head; it accepts no out_grads"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad, ctx=self._scores.context)
            self._scores_grad = grad
        else:
            # default: cross-entropy over softmax scores, the head the
            # reference shipped
            scores = self._scores
            labels = self._labels.astype("int32")
            prob = scores.asnumpy()
            import numpy as _np
            # (p - onehot), unnormalized: the chained Module's
            # rescale_grad=1/batch applies the normalization once
            g = prob.copy()
            g[_np.arange(g.shape[0]), labels.asnumpy().astype(int)] -= 1.0
            self._scores_grad = nd.array(g, ctx=scores.context)

    def get_input_grads(self, merge_multi_context=True):
        if self._scores_grad is None:
            raise MXNetError("call backward() before get_input_grads()")
        return [self._scores_grad]

    def install_monitor(self, mon):
        pass
