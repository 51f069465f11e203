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
:mod:`callback`, :mod:`monitor`, checkpoints in :mod:`model`) and, given a
:mod:`kvstore` (``mx.kv.create("device")``, or ``"dist_sync"`` across
``tools/launch.py``'s processes on ``torch.distributed``), updates on
the store as ``train_imagenet.py`` does; over a context list it runs one
replica a context (:mod:`parallel`, the mesh and collectives); the vision zoo
(``gluon.model_zoo.vision``) and the conv layers run on ``Convolution``
and ``Pooling`` (cuDNN on the card), with the fuse pass folding
convolution, BatchNorm and activation into one node.  The host planes
are :mod:`fault` (named fault sites), :mod:`elastic` (the launcher's
identity contract), :mod:`telemetry` (metrics, spans, flight recorder,
request traces), :mod:`profiler`, :mod:`watchdog` (leases, stall exit,
heartbeats) and :mod:`checkpoint` (``CheckpointManager``); the serving
fleet is :mod:`serving` with its worker ``mxnet_tpu_torch.serving.worker``.
The training loops carry the same planes (fault sites, leases, flight
records, checksummed state files), and :mod:`stream` feeds them from
RecordIO/JSONL shard sets (:mod:`recordio`) exactly once across an
elastic world; :mod:`config` registers every environment knob.  Images
come through :mod:`image` (decode, augmenters, ``ImageIter``,
``ImageDetIter``) and the record iterators ``io.ImageRecordIter`` and
``io.ImageDetRecordIter``, which decode on the threads of the native
library (:mod:`_native`, built at first use); SSD's ``MultiBox`` operators
are in :mod:`ops.contrib` (``mx.sym.contrib``, ``mx.nd.contrib``).
Recurrent models are :mod:`rnn` (``mx.rnn``: symbolic cells, the fused
``RNN`` operator's cell, ``BucketSentenceIter`` for ``BucketingModule``)
and ``gluon.rnn`` (the cells and the fused ``RNN``/``LSTM``/``GRU``
layers).  The operator registry holds every op of the reference's (the
tensor, nn and legacy tails, ``linalg``, the samplers, the R-CNN ops),
and :mod:`operator` (``mx.operator``) runs Python-defined ops
(``CustomOp``/``CustomOpProp``/``register``) as ``Custom`` from
``mx.nd``, ``mx.sym`` and Gluon.
"""
from . import config, elastic, fault, telemetry, watchdog
from . import checkpoint, profiler, recordio
from . import operator  # registers Custom before nd and sym populate
from . import (autograd, base, context, initializer, ndarray, ops,
               optimizer, random)
from . import attribute, name, symbol, graph, executor, rtc
from . import (callback, io, kvstore, lr_scheduler, metric, model,
               module, monitor, precision)
from . import gluon, serving, stream, image, rnn
from .attribute import AttrScope
from .base import MXNetError
from .checkpoint import CheckpointManager
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
kv = kvstore
init = initializer
opt = optimizer
rnd = random

# launcher-spawned workers find MXTPU_HEARTBEAT_DIR and become observable
watchdog._maybe_start_heartbeat()

__all__ = ["config", "elastic", "fault", "telemetry", "watchdog",
           "checkpoint", "profiler", "recordio", "stream", "image", "rnn",
           "operator",
           "CheckpointManager",
           "autograd", "base", "context", "gluon", "initializer", "init",
           "ndarray", "nd", "ops", "optimizer", "opt", "random", "rnd",
           "serving", "attribute", "name", "symbol", "sym", "graph",
           "executor", "rtc", "callback", "io", "kvstore", "kv",
           "lr_scheduler", "metric",
           "model", "module", "mod", "monitor", "precision", "AttrScope",
           "Context", "Executor", "LossScaler", "MXNetError", "Module",
           "Monitor", "NameManager", "NDArray", "PrecisionPolicy", "Prefix",
           "Symbol", "cpu", "current_context", "gpu", "num_gpus"]
