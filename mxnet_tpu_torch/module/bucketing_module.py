"""BucketingModule: variable-length sequence training (the PyTorch
package's copy of ``mxnet_tpu/module/bucketing_module.py``).

One Module a bucket, bound at the bucket's first batch; the parameters
are shared through the default bucket's host copy, pushed into the
active bucket's executor at every switch and synced back after every
update, and every bucket updates through the default bucket's optimizer
and Updater (its split path: ``fit`` runs ``forward_backward`` and
``update``).
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _gen_symbol(self, key):
        out = self._sym_gen(key)
        if isinstance(out, tuple):
            return out
        return (out, ("data",), ("softmax_label",))

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._gen_symbol(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._gen_symbol(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        symbol, data_names, label_names = \
            self._gen_symbol(self._default_bucket_key)
        module = Module(symbol, data_names, label_names,
                        logger=self.logger, context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch to (possibly compiling) the module for bucket_key
        (reference bucketing_module.py:switch_bucket)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._gen_symbol(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names)
            module.bind(data_shapes, label_shapes, self._curr_module.
                        for_training, self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module) \
                    if hasattr(mod, "borrow_optimizer") else None
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        assert self.binded and self.params_initialized
        original_bucket_key = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        # restore the active module too, not just the key — update_metric
        # after prepare() must read the executor that actually ran
        # (reference bucketing_module.py prepare)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._share_params_with_current()
        self._curr_module.forward(data_batch, is_train=is_train)

    def _share_params_with_current(self):
        """Propagate the shared parameter values into the active bucket.

        Invariant: the default module's _arg_params dict is the single
        source of truth (kept fresh by update()); every switch pushes it
        into the active bucket's executor.
        """
        default_mod = self._buckets[self._default_bucket_key]
        self._curr_module._arg_params = default_mod._arg_params
        self._curr_module._aux_params = default_mod._aux_params
        self._curr_module.params_initialized = True
        self._curr_module._push_params_to_exec()

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._share_params_with_current()
        self._curr_module.forward_backward(data_batch)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if not self._curr_module.optimizer_initialized:
            self._curr_module._optimizer = \
                self._buckets[self._default_bucket_key]._optimizer
            self._curr_module._updater = \
                self._buckets[self._default_bucket_key]._updater
            self._curr_module._kvstore = \
                self._buckets[self._default_bucket_key]._kvstore
            self._curr_module._update_on_kvstore = \
                self._buckets[self._default_bucket_key]._update_on_kvstore
            self._curr_module._fused = opt.FusedUpdate(
                self._curr_module._optimizer, self._curr_module._updater)
            self._curr_module.optimizer_initialized = True
        self._curr_module.update()
        # keep the shared param dict fresh (see _share_params_with_current)
        self._curr_module._sync_params_from_devices()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
