"""PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of it.  Its kernels are written by hand for Hopper
(``csrc/``) and built at first use (:mod:`.ops._build`).  Entry points run
on the first CUDA card unless the caller passes ``device="cpu"`` (or
``ctx=mx.cpu()``).

It serves GPT decoder models through :class:`serving.ServingEngine` with
the paged-attention kernels, trains them through the Gluon loop
(:mod:`autograd`, :mod:`gluon.loss`, :class:`gluon.Trainer`,
:mod:`optimizer`) with the flash-attention kernels, and runs symbolic
graphs (``mx.sym`` -> ``simple_bind`` -> graph passes -> :class:`Executor`)
with the fused LayerNorm-residual kernel.  ``mx.nd`` is the imperative
API (every registered op as ``nd.<op>``, the tape in :mod:`autograd`),
and :mod:`rtc` compiles user kernels at run time (``CudaRtc``: CUDA C++
built by ``nvcc``).  ``mx.mod.Module`` trains a symbol through ``fit``
(the fused, guarded step; :mod:`io` iterators, :mod:`metric`,
:mod:`lr_scheduler`, :mod:`callback`, :mod:`monitor`, checkpoints in
:mod:`model`).
"""
from . import (autograd, base, context, gluon, initializer, ndarray, ops,
               optimizer, serving)
from . import attribute, name, symbol, graph, executor, rtc
from . import (callback, io, lr_scheduler, metric, model, module,
               monitor, precision)
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from .executor import Executor
from .monitor import Monitor

nd = ndarray
sym = symbol
mod = module
init = initializer

__all__ = ["autograd", "base", "context", "gluon", "initializer", "init",
           "ndarray", "nd", "ops", "optimizer", "serving", "attribute",
           "name", "symbol", "sym", "graph", "executor", "rtc", "callback",
           "io", "lr_scheduler", "metric", "model", "module", "mod",
           "monitor", "precision", "AttrScope", "Context", "Executor", "MXNetError",
           "Monitor", "cpu", "current_context", "gpu", "num_gpus"]
