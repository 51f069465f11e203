"""``shard_map`` on ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel/_shard_map.py``).

``shard_map(fn, mesh, in_specs, out_specs)(*args)`` runs ``fn`` once on
THIS rank's shard of each argument: an argument's dimension named by its
spec's axis is cut into that axis's size and this rank keeps the chunk of
its coordinate (a replicated spec passes the argument whole).  ``fn``
runs under ``mesh``, so the collectives of :mod:`.collectives` name its
axes.  Each output is then assembled the way its out-spec says: a dim
named by an axis is gathered over that axis's group (every rank returns
the whole, as the reference returns the global array), a replicated
output is this rank's value.  The reference's partial-auto mode
(``axis_names``) has no torch meaning and raises.
"""
from __future__ import annotations

import torch

from . import collectives as _col
from .sharding import PartitionSpec, local_shard


def _global(y, spec, mesh):
    if not isinstance(y, torch.Tensor):
        return y
    for dim, entry in reversed(list(enumerate(tuple(spec or ())))):
        if entry is None:
            continue
        for a in reversed(entry if isinstance(entry, tuple) else (entry,)):
            y = _col.allgather(y, a, tiled_axis=dim, mesh=mesh)
    return y


def _per_item(specs, n):
    """One spec for each of ``n`` items: a single PartitionSpec (or None)
    is every item's, a sequence gives them in order."""
    if specs is None or isinstance(specs, PartitionSpec):
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError("%d specs for %d values" % (len(specs), n))
    return specs


def shard_map(fn, mesh, in_specs, out_specs, check_rep=False,
              axis_names=None):
    """See the module's docstring."""
    if axis_names is not None:
        raise ValueError(
            "partial-auto shard_map (axis_names) has no torch meaning: the "
            "port has no compiler propagating the other axes")

    def wrapped(*args):
        local = [local_shard(a, sp or (), mesh)
                 if isinstance(a, torch.Tensor) else a
                 for a, sp in zip(args, _per_item(in_specs, len(args)))]
        _col.push_mesh(mesh)
        try:
            out = fn(*local)
        finally:
            _col.pop_mesh()
        if isinstance(out, (tuple, list)):
            return type(out)(_global(y, sp, mesh) for y, sp in
                             zip(out, _per_item(out_specs, len(out))))
        return _global(out, out_specs, mesh)

    return wrapped
