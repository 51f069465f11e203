"""Module: the symbolic training Model API (counterpart of
``mxnet_tpu/module/module.py``).

One executor on one device (the card unless ``context`` or a ``with
mx.Context(...)`` scope names the CPU).  ``Module.fit`` runs
:meth:`Module.fit_step` a batch: where the configuration allows
(``_fused_eligible``: SGD, SGD with momentum or Adam, ``grad_req`` write,
no monitor, no input gradients) one fused step, the executor's
``make_fit_step``: the training forward, ``torch.autograd.grad`` on the
parameters and one guarded multi-tensor optimizer update in place.  A
non-finite gradient leaves every parameter and optimizer state bit for
bit as it was and rewinds the optimizer clocks; the verdict is read at
once, as the reference's Module reads it, and ``MXNetError`` ends the run
after ``MXTPU_MAX_CONSECUTIVE_SKIPS`` consecutive skips.  Other
configurations run the split pair ``forward_backward`` + ``update``
through the optimizer's ``Updater``, and the optimizer state moves
between the two forms both ways.

The Module keeps its own copy of the parameters on the host
(``get_params``), synced from the device when read, as MXNet's Module
keeps its ``_arg_params``.  Optimizer states save and load as the
Updater's pickle, within this package; the reference's checksummed state
framing and checkpoint manifest come with ``checkpoint.py`` (S4), and
multi-device contexts, kvstores and ``partition_rules`` with S5.
"""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError, atomic_write
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _update_params, load_checkpoint,
                     save_checkpoint)
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError(
                    "Module over %d devices: the multi-device slice of the "
                    "port (S5)" % len(context))
            context = context[0]
        self._device = ctx_mod.resolve_device(context)
        self._context = [self._device]

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []

        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._fused = None               # an optimizer.FusedUpdate
        self._fit_step = None            # (its key, the executor's step)
        self._precision = None           # a precision.PrecisionPolicy

        self._exec = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (reference ``module.py:146``)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``, each written
        atomically."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties --------------------------------------------------------
    @property
    def graph_report(self):
        """The bind's graph-pass report, or None before bind / with the
        pipeline off."""
        return self._exec._graph_report if self._exec is not None else None

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
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        _, out_shapes, _ = self._symbol.infer_shape(
            **dict(self._data_shapes + (self._label_shapes or [])))
        return list(zip(self._output_names, out_shapes))

    # -- parameters --------------------------------------------------------
    def get_params(self):
        """The host copy of the parameters, synced from the device first."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the host copy from ``arg_params``/``aux_params`` (NDArrays,
        tensors or numpy arrays, by name) or the initializer, then copy it
        to the device (reference ``module.py:193``)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        host = ctx_mod.cpu()
        if self._arg_params is None:
            self._arg_params = {
                name: nd.zeros(self._exec.arg_dict[name].shape, ctx=host,
                               dtype=self._exec.arg_dict[name].dtype)
                for name in self._param_names}
        if self._aux_params is None:
            self._aux_params = {
                name: nd.zeros(self._exec.aux_dict[name].shape, ctx=host,
                               dtype=self._exec.aux_dict[name].dtype)
                for name in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(desc, arr, cache):
            if cache is not None and desc in cache:
                cache_arr = cache[desc]
                if cache_arr is not arr:
                    if tuple(cache_arr.shape) != arr.shape:
                        raise MXNetError("Shape mismatch for %s: %s vs %s"
                                         % (desc, tuple(cache_arr.shape),
                                            arr.shape))
                    arr[:] = cache_arr
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % desc)
            elif initializer is not None:
                initializer(desc, arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(InitDesc(name, attrs.get(name)), arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(InitDesc(name, attrs.get(name)), arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._push_params_to_exec()

    def _push_params_to_exec(self):
        for name, arr in self._arg_params.items():
            if name in self._exec.arg_dict:
                self._exec.arg_dict[name][:] = arr
        for name, arr in self._aux_params.items():
            if name in self._exec.aux_dict:
                self._exec.aux_dict[name][:] = arr

    def _sync_params_from_devices(self):
        for name in self._param_names:
            self._arg_params[name][:] = self._exec.arg_dict[name]
        for name in self._aux_names:
            self._aux_params[name][:] = self._exec.aux_dict[name]
        self._params_dirty = False

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the symbol for the given shapes (reference
        ``module.py:262``); the graph passes rewrite it at bind."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        # the fused step closes over the executor being replaced; its
        # optimizer state survives through the Updater
        if self._fused is not None:
            self._fused.drop()
        self._fit_step = None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

        def _norm(shapes):
            if shapes is None:
                return None
            return [(s.name, tuple(s.shape)) if hasattr(s, "name")
                    else (s[0], tuple(s[1])) for s in shapes]

        self._data_shapes = _norm(data_shapes)
        self._label_shapes = _norm(label_shapes)
        shape_kwargs = dict(self._data_shapes)
        if self._label_shapes:
            shape_kwargs.update(dict(self._label_shapes))

        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or name in self._state_names \
                    or name in self._fixed_param_names or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(name, "write")
        self._exec = self._symbol.simple_bind(self._device, grad_req=req,
                                              **shape_kwargs)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
            self._push_params_to_exec()
        elif self.params_initialized:
            self._push_params_to_exec()

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Set up the optimizer (reference ``module.py:339``); gradients
        are rescaled by ``1 / batch_size`` unless ``optimizer_params``
        names ``rescale_grad``."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._data_shapes[0][1][0]
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        optimizer.set_lr_mult({})
        optimizer.set_wd_mult({})
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._fused = opt.FusedUpdate(optimizer, self._updater)
        self._fused.precision = self._precision
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- computation -------------------------------------------------------
    def _feed_batch(self, data_batch):
        feeds = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            feeds.update(zip(self._label_names, data_batch.label))
        return feeds

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._feed_batch(data_batch))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self._exec.forward_backward(**self._feed_batch(data_batch))

    def set_precision(self, policy):
        """Install a :class:`~mxnet_tpu_torch.precision.PrecisionPolicy`
        (or None).  Its fingerprint keys the fused step (a change
        rebuilds it; the optimizer state carries over through the
        Updater), and its loss scaler's ``1 / scale`` joins the step's
        ``rescale_grad`` and consumes the guard's verdict."""
        self._precision = policy
        if self._fused is not None:
            self._fused.precision = policy

    @property
    def _consec_guard_skips(self):
        return self._fused.streak if self._fused is not None else 0

    # -- fused fit step ----------------------------------------------------
    def _fused_eligible(self):
        """Can this configuration run forward, backward and the update as
        one fused step?  A kvstore, ``grad_req="add"``, input gradients, an
        installed monitor and optimizers without a fused kind keep the
        split path."""
        if self._kvstore is not None or self._update_on_kvstore:
            return False
        if self._optimizer is None or self._optimizer.fused_kind() is None:
            return False
        if self._exec is None or self._exec._monitor_callback is not None:
            return False
        if self.inputs_need_grad:
            return False
        return all(self._exec._grad_req.get(n, "null") in ("write", "null")
                   for n in self._param_names)

    def _fused_setup(self):
        """(Re)build the fused update over the ``grad_req="write"``
        parameters (:class:`~mxnet_tpu_torch.optimizer.FusedUpdate` keys
        it) and the executor's fit step around it.  Returns the step and
        the updated parameters by name."""
        exe = self._exec
        keys = {i: n for i, n in enumerate(self._param_names)
                if exe._grad_req.get(n) == "write"}
        params = {n: exe.arg_dict[n].data for n in keys.values()}
        self._fused.configure(keys, params)
        if self._fit_step is None or self._fit_step[0] is not \
                self._fused.key:
            self._fit_step = (self._fused.key, exe.make_fit_step(
                list(keys.values()), self._fused.guarded))
        return self._fit_step[1], params

    def fit_step(self, data_batch):
        """One training step: the fused step where eligible, else
        ``forward_backward`` + ``update``."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if not self._fused_eligible():
            return super().fit_step(data_batch)
        step, params = self._fused_setup()
        exe = self._exec
        for k, v in self._feed_batch(data_batch).items():
            exe.arg_dict[k][:] = v
        other = {n: a.data for n, a in exe.arg_dict.items()
                 if n not in params}
        outs, ok = step(params, self._fused.state, other,
                        *self._fused.begin())
        exe.outputs = [NDArray(o, exe._ctx) for o in outs]
        self._params_dirty = True
        # read at once (the metric update that follows waits for the
        # device anyway): a skipped step rewinds the optimizer clocks
        self._fused.finish(ok)

    def update(self):
        """Apply the optimizer to the gradients in ``grad_dict`` through
        the Updater (reference ``module.py:699``)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        # the fused state seeds the Updater, and the Updater's the next
        # fused step
        self._fused.drop()
        self._params_dirty = True
        _update_params([[self._exec.arg_dict[n]] for n in self._param_names],
                       [[self._exec.grad_dict.get(n)]
                        for n in self._param_names],
                       updater=self._updater, num_device=1)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self._exec.outputs)

    def install_monitor(self, mon):
        assert self.binded
        mon.install(self._exec)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        if states is not None:
            for name, arr in zip(self._state_names, states):
                self._exec.arg_dict[name][:] = arr
        else:
            for name in self._state_names:
                self._exec.arg_dict[name][:] = value

    # -- optimizer state io -------------------------------------------------
    def save_optimizer_states(self, fname):
        """The Updater's states (fused state flushed into it first),
        pickled with every tensor on the host and written atomically."""
        assert self.optimizer_initialized
        self._fused.flush()
        atomic_write(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        self._fused.drop(flush=False)  # re-seeded from the loaded states
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._fused.streak = 0

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind for new shapes; the parameters carry over."""
        assert self.binded
        if self._params_dirty:
            self._sync_params_from_devices()
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True)
