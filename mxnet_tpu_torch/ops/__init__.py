"""Operators of the PyTorch package.

- The operator registry (:mod:`.registry`) and the ops the symbolic,
  imperative and Gluon paths use (:mod:`.tensor`, :mod:`.nn`, the
  optimizer updates in :mod:`.optimizer_ops`, the graph pipeline's fused
  regions in :mod:`.fused`, the flash-attention op in :mod:`.tail`);
  importing this package registers them, as importing the
  reference's ``mxnet_tpu.ops`` does.
- Hand-written CUDA kernels, each beside its plain PyTorch version
  (:mod:`.paged_attention`, :mod:`.flash_attention`, :mod:`.layer_norm`),
  built by :mod:`._build`.
"""
from .registry import OpDef, alias, get_op, list_ops, register_op
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import fused  # noqa: F401  (graph-pass fused regions)
from . import tail  # noqa: F401

__all__ = ["OpDef", "register_op", "get_op", "list_ops", "alias"]
