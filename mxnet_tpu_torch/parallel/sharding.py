"""Partition rules and specs (counterpart of
``mxnet_tpu/parallel/sharding.py``).

The spec functions are pure and return the reference's specs on the same
names, shapes and mesh sizes: :class:`PartitionRule` (a name regex, an
optional ndim and a spec), :func:`spec_for`, :func:`match_partition_rules`
(first matching rule, replicated when none matches, scalars never
partitioned, and with a mesh each spec validated against the shape: a
dimension that does not divide, or an axis the mesh lacks, falls back to
replication, warned once per name and counted on ``sharding.fallbacks``),
:func:`zero1_spec`/:func:`zero1_partition` (ZeRO-1: the first dimension
the base spec leaves free that divides the ``dp`` size) and
:func:`batch_spec`.  :class:`PartitionSpec` (``P``) is a tuple of axis
names or None per dimension, as JAX's.

Placement, the torch meaning: :func:`shard_params` gives each rank its
shard of every parameter over a rank mesh (:func:`local_shard`).  The
reference's
``fresh_device_put`` and donation guard against XLA buffer aliasing,
which torch's eager tensors do not have: they are not ported.
"""
from __future__ import annotations

import logging
import math
import re
import threading

from .mesh import AXIS_DP, AXIS_TP


class PartitionSpec(tuple):
    """Per-dimension mesh axis (or None), like ``jax.sharding.
    PartitionSpec``: ``P("dp", None)``; ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class PartitionRule:
    """(name_regex, ndim or None, PartitionSpec)."""

    def __init__(self, pattern, spec, ndim=None):
        self.pattern = re.compile(pattern)
        self.spec = spec if isinstance(spec, P) else P(*spec)
        self.ndim = ndim

    def matches(self, name, val):
        if self.ndim is not None and _ndim(val) != self.ndim:
            return False
        return self.pattern.search(name) is not None


def _ndim(val):
    nd = getattr(val, "ndim", None)
    if nd is None and hasattr(val, "shape"):
        nd = len(val.shape)
    return nd


def make_sharding_rules(*rules):
    return [r if isinstance(r, PartitionRule) else PartitionRule(*r)
            for r in rules]


#: default tensor-parallel rules for the framework's layer naming
DEFAULT_TP_RULES = make_sharding_rules(
    (r"(dense|fc|proj|embedding).*weight$", P(AXIS_TP, None), 2),
    (r"conv.*weight$", P(AXIS_TP, None, None, None), 4),
    (r"(dense|fc|proj).*bias$", P(AXIS_TP), 1),
)


def spec_for(name, val, rules):
    for r in rules:
        if r.matches(name, val):
            return r.spec
    return P()  # replicated


def match_partition_rules(rules, params, mesh=None, scalars_replicated=True):
    """``{name: PartitionSpec}`` for a ``{name: array-or-shaped}`` dict: the
    first matching rule's spec, replicated when none matches; scalars and
    one-element leaves are never partitioned; with ``mesh`` each spec is
    validated against the leaf's shape (see the module's docstring)."""
    rules = make_sharding_rules(*rules) if rules else []
    out = {}
    for name, val in params.items():
        shape = tuple(getattr(val, "shape", ()))
        if scalars_replicated and (not shape or math.prod(shape) == 1):
            out[name] = P()
            continue
        spec = spec_for(name, val, rules)
        if mesh is not None:
            spec = _validate_spec(spec, shape, mesh, name=name)
        out[name] = spec
    return out


def zero1_spec(shape, mesh, axis=AXIS_DP, base=None, name=None):
    """ZeRO-1 placement of one gradient / optimizer-state leaf: shard the
    first dim divisible by the ``axis`` size that the base (param) spec
    leaves unsharded (arXiv 2004.13336); the base spec (replication) when
    none divides, counted on ``sharding.fallbacks``."""
    shape = tuple(shape)
    base_t = tuple(base or ()) + (None,) * (len(shape) - len(base or ()))
    if axis not in mesh.shape:
        if math.prod(shape or (1,)) > 1:
            _note_missing_axis(name, shape, [axis], mesh)
        return P(*base_t) if base else P()
    n = mesh.shape[axis]
    if n > 1:
        for d, s in enumerate(shape):
            if base_t[d] is None and s and s % n == 0:
                return P(*(base_t[:d] + (axis,) + base_t[d + 1:]))
    if n > 1 and math.prod(shape or (1,)) > 1 and \
            all(a is None for a in base_t):
        _note_fallback(name, shape, (axis,), n)
    return P(*base_t) if base else P()


def zero1_partition(params, mesh, axis=AXIS_DP, base_specs=None):
    """{name: PartitionSpec} sharding every leaf 1/N over ``axis`` where
    its shape allows (:func:`zero1_spec`)."""
    base_specs = base_specs or {}
    return {
        name: zero1_spec(getattr(val, "shape", ()), mesh, axis=axis,
                         base=base_specs.get(name), name=name)
        for name, val in params.items()}


def zero1_dim(spec, axis=AXIS_DP):
    """The dimension a ZeRO-1 spec shards over ``axis`` (None: none)."""
    for d, entry in enumerate(tuple(spec or ())):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


def local_shard(x, spec, mesh, coords=None):
    """This rank's shard of ``x`` under ``spec`` on a rank mesh (``x``
    whole for a replicated spec)."""
    import torch
    if coords is None:
        coords = mesh.coords() if mesh.size > 1 else \
            {a: 0 for a in mesh.axis_names}
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n = mesh.shape[a]
            if x.shape[dim] % n:
                raise ValueError("dim %d of shape %s does not divide over "
                                 "axis %r of size %d"
                                 % (dim, tuple(x.shape), a, n))
            x = torch.chunk(x, n, dim=dim)[coords[a]]
    return x


def shard_params(params, mesh, rules=None, donate=False):
    """``{name: this rank's shard}`` of a ``{name: tensor}`` dict over a
    rank mesh, placed per the rules; a dim that does not divide falls
    back to replication (warned once per name, counted on
    ``sharding.fallbacks``).  ``donate`` is accepted for the reference's
    signature: a torch shard is a view or a copy, never an alias to
    guard."""
    rules = make_sharding_rules(*rules) if rules else []
    out = {}
    for name, val in params.items():
        spec = _validate_spec(spec_for(name, val, rules),
                              tuple(getattr(val, "shape", ())), mesh,
                              name=name)
        out[name] = local_shard(val, spec, mesh)
    return out


_fallback_warned = set()
_fallback_lock = threading.Lock()


def _note_fallback(name, shape, axes, size):
    from .. import telemetry as _telemetry
    _telemetry.counter("sharding.fallbacks").inc()
    label = name if name is not None else "<unnamed>"
    with _fallback_lock:
        if label in _fallback_warned:
            return
        _fallback_warned.add(label)
    logging.warning(
        "mxnet_tpu_torch.parallel.sharding: %r (shape %s) cannot shard "
        "over mesh axes %s (size %d does not divide the dim); replicating "
        "instead (counter: sharding.fallbacks)",
        label, tuple(shape), tuple(axes), size)


def _validate_spec(spec, shape, mesh, name=None):
    fixed = []
    for d, axis in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            fixed.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            fixed.append(None)
            _note_missing_axis(name, shape, missing, mesh)
            continue
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if shape[d] % size == 0:
            fixed.append(axis)
        else:
            fixed.append(None)
            _note_fallback(name, shape, axes, size)
    if all(a is None for a in fixed):  # canonical: replicated is P()
        fixed = []
    return P(*fixed)


def _note_missing_axis(name, shape, missing, mesh):
    from .. import telemetry as _telemetry
    _telemetry.counter("sharding.fallbacks").inc()
    label = name if name is not None else "<unnamed>"
    with _fallback_lock:
        if (label, "axis") in _fallback_warned:
            return
        _fallback_warned.add((label, "axis"))
    logging.warning(
        "mxnet_tpu_torch.parallel.sharding: %r (shape %s) names mesh axes "
        "%s this mesh %s does not have; replicating that dim instead "
        "(counted on sharding.fallbacks)",
        label, tuple(shape), missing, dict(mesh.shape))


def batch_spec(ndim, axis=AXIS_DP):
    """PartitionSpec sharding dim 0 (the batch) over ``axis``."""
    return P(axis, *([None] * (ndim - 1)))
