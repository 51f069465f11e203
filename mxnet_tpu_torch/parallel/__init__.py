"""Data parallelism of the PyTorch package (counterpart of
``mxnet_tpu/parallel/``, its data-parallel half).

Two levels, where the reference runs one SPMD program over a
``jax.sharding.Mesh``:

- across processes (``tools/launch.py -n N``), one rank a process on
  ``torch.distributed``: a :class:`~.mesh.Mesh` names the reference's axes
  (``dp``, ``tp``, ``pp``, ``sp``, ``ep``) over the job's ranks, a
  collective is a ``torch.distributed`` call on an axis's group,
  :func:`shard_map` runs ``fn`` on this rank's shard, and
  :func:`make_train_step` all-reduces the gradients over ``dp``;
- in one process over a context list (``Module(context=[...])``,
  ``Parameter.initialize(ctx=[...])``): one replica a context
  (:func:`~.mesh.dp_mesh_from_ctx`), see ``executor.py``.

Modules: :mod:`.mesh`, :mod:`.collectives`, :mod:`._shard_map`,
:mod:`.sharding`, :mod:`.data_parallel`.  Sequence, expert and pipeline
parallelism (``ring_attention_fn``, ``ulysses_attention``, ``MoELayer``,
``shard_gpt``, ``pipeline_*``) are the next slice of the port (S5b):
reaching for them raises an ``AttributeError`` that says so.
"""
from . import mesh
from .mesh import (MeshSpec, Mesh, make_mesh, device_mesh_shape,
                   dp_mesh_from_ctx, full_mesh, AXIS_DP, AXIS_TP, AXIS_PP,
                   AXIS_SP, AXIS_EP)
from . import collectives
from .collectives import (allreduce, allgather, reduce_scatter, alltoall,
                          ring_permute, broadcast_from, axis_index,
                          axis_size)
from ._shard_map import shard_map
from . import sharding
from .sharding import (PartitionSpec, PartitionRule, make_sharding_rules,
                       shard_params, match_partition_rules, zero1_spec,
                       zero1_partition)
from . import data_parallel
from .data_parallel import make_train_step, DataParallelTrainer

#: the reference's names of sequence, expert and pipeline parallelism
_S5B = ("ring_attention", "ring_attention_fn", "ulysses",
        "ulysses_attention", "moe", "MoELayer", "moe_apply", "gpt_spmd",
        "shard_gpt", "gpt_param_spec", "pipeline", "pipeline_apply",
        "pipeline_apply_1f1b", "pipeline_apply_1f1b_het",
        "stage_param_shardings", "gpt_pp")


def __getattr__(name):
    if name in _S5B:
        raise AttributeError(
            "mxnet_tpu_torch.parallel.%s: sequence, expert and pipeline "
            "parallelism are the next slice of the port (S5b)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
