"""PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of it.  Its kernels are written by hand for Hopper
(``csrc/``) and built at first use (:mod:`.ops._build`).  Entry points run
on the first CUDA card unless the caller passes ``device="cpu"`` or
``ctx=mx.cpu()``, or opens ``with mx.cpu():``.

It serves GPT decoder models through :class:`serving.ServingEngine` with
the paged-attention kernels, and trains them through Gluon
(:mod:`gluon`: ``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``
with ``hybridize()``, the layers, losses, ``Trainer`` and data loading,
fed ``mx.nd`` arrays or raw torch tensors) with the flash-attention
kernels.  It runs symbolic graphs (``mx.sym`` -> ``simple_bind`` -> graph
passes -> :class:`Executor`) with the fused LayerNorm-residual kernel,
which a hybridized Gluon block reaches as well.  ``mx.nd`` is the
imperative API (every registered op as ``nd.<op>``, the tape in
:mod:`autograd`, the generators of :mod:`random`), and :mod:`rtc`
compiles user kernels at run time (``CudaRtc``: CUDA C++ built by
``nvcc``).  ``mx.mod.Module`` trains a symbol through ``fit`` (the fused,
guarded step; :mod:`io` iterators, :mod:`metric`, :mod:`lr_scheduler`,
:mod:`callback`, :mod:`monitor`, checkpoints in :mod:`model`).
"""
from . import (autograd, base, context, initializer, ndarray, ops,
               optimizer, random)
from . import attribute, name, symbol, graph, executor, rtc
from . import (callback, io, lr_scheduler, metric, model, module,
               monitor, precision)
from . import gluon, serving
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from .executor import Executor
from .module import Module
from .monitor import Monitor
from .name import NameManager, Prefix
from .ndarray import NDArray
from .precision import LossScaler, PrecisionPolicy
from .symbol import Symbol

nd = ndarray
sym = symbol
mod = module
init = initializer
opt = optimizer
rnd = random

__all__ = ["autograd", "base", "context", "gluon", "initializer", "init",
           "ndarray", "nd", "ops", "optimizer", "opt", "random", "rnd",
           "serving", "attribute", "name", "symbol", "sym", "graph",
           "executor", "rtc", "callback", "io", "lr_scheduler", "metric",
           "model", "module", "mod", "monitor", "precision", "AttrScope",
           "Context", "Executor", "LossScaler", "MXNetError", "Module",
           "Monitor", "NameManager", "NDArray", "PrecisionPolicy", "Prefix",
           "Symbol", "cpu", "current_context", "gpu", "num_gpus"]
