"""Operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

Each operator is a function ``fn(*tensors, **params) -> tensor | tuple``
of torch ops plus MXNet's metadata:

- ``arg_names``: named inputs (data and learnable parameters), possibly a
  function of the op's params (FullyConnected's ``no_bias``);
- ``aux_names``: auxiliary states, excluded from the gradient;
- ``num_outputs``: static or a function of the params;
- ``mutate_aux``, ``backward_ignore``, ``needs_rng``, ``takes_train``: as
  in the reference.

The reference jit-compiles each op per static param set and derives shape
inference from ``jax.eval_shape``.  Here ops run eagerly, and shape
inference (``Symbol.infer_shape``) runs the same op bodies on ``meta``
tensors, which carry shapes and dtypes but no data.  So no op may read
its data to decide a shape.

An op with no array inputs (``_arange``, ``_graph_constant``) creates its
output on a device: its ``fn`` takes a ``_device`` keyword, which the
executor (and shape inference, with ``meta``) passes, as it passes
``_train`` to ``takes_train`` ops (:attr:`OpDef.takes_device`).
"""
from __future__ import annotations

__all__ = ["OpDef", "register_op", "get_op", "list_ops", "alias"]

_OP_REGISTRY: dict = {}


def _hashable(value):
    """Canonicalize a param value into something hashable (CSE keys)."""
    if isinstance(value, (list, tuple)):
        return tuple(_hashable(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in value.items()))
    return value


class OpDef:
    """A registered operator."""

    def __init__(self, name, fn, arg_names=("data",), aux_names=(),
                 num_outputs=1, param_defaults=None, mutate_aux=False,
                 backward_ignore=(), needs_rng=False, takes_train=False):
        self.name = name
        self.fn = fn
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._num_outputs = num_outputs
        self.param_defaults = dict(param_defaults or {})
        # aux inputs the op updates in place during training (BatchNorm)
        self.mutate_aux = mutate_aux
        # arg names that never receive gradient (labels of loss heads)
        self.backward_ignore = tuple(backward_ignore)
        # op draws randomness (from mxnet_tpu_torch.random's generator of
        # its device; the reference's op takes a key argument instead)
        self.needs_rng = needs_rng
        # op behaves differently in training: fn takes kwarg ``_train``
        self.takes_train = takes_train

    # -- metadata ---------------------------------------------------------
    @property
    def takes_device(self):
        """True for an op with no array inputs: its ``fn`` takes the
        device to create its output on as ``_device``."""
        return not callable(self._arg_names) and not self._arg_names \
            and not self._aux_names

    def arg_names(self, params=None):
        if callable(self._arg_names):
            return list(self._arg_names(params or {}))
        return list(self._arg_names)

    def aux_names(self, params=None):
        if callable(self._aux_names):
            return list(self._aux_names(params or {}))
        return list(self._aux_names)

    def num_outputs(self, params=None):
        if callable(self._num_outputs):
            return self._num_outputs(params or {})
        return self._num_outputs

    def canon_params(self, params):
        """Merge with defaults, dropping Nones that have no default."""
        merged = dict(self.param_defaults)
        merged.update({k: v for k, v in params.items()
                       if v is not None or k in merged})
        return merged

    def __call__(self, *tensors, **params):
        return self.fn(*tensors, **self.canon_params(params))

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register_op(name, arg_names=("data",), aux_names=(), num_outputs=1,
                param_defaults=None, mutate_aux=False, backward_ignore=(),
                needs_rng=False, takes_train=False):
    """Decorator registering ``fn`` as operator ``name``."""
    def _reg(fn):
        _OP_REGISTRY[name] = OpDef(
            name, fn, arg_names=arg_names, aux_names=aux_names,
            num_outputs=num_outputs, param_defaults=param_defaults,
            mutate_aux=mutate_aux, backward_ignore=backward_ignore,
            needs_rng=needs_rng, takes_train=takes_train)
        return fn
    return _reg


def alias(name, *aliases):
    """Register additional names for an existing op."""
    op = _OP_REGISTRY[name]
    for a in aliases:
        _OP_REGISTRY[a] = op


def get_op(name):
    op = _OP_REGISTRY.get(name)
    if op is None:
        raise KeyError("Operator %s is not registered" % name)
    return op


def list_ops():
    return sorted(_OP_REGISTRY)
