"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

A :class:`Mesh` names the axes of a job's parallelism over an array of
members, with the reference's axis names (``dp``, ``tp``, ``pp``, ``sp``,
``ep``) and its ``shape`` mapping (axis -> size).  Two kinds of member,
for the two levels of the port's data parallelism:

- ranks of ``torch.distributed`` (:func:`make_mesh`, :func:`full_mesh`):
  one process a member; :meth:`Mesh.group` is the process group of an
  axis through this rank and :attr:`Mesh.device_mesh` the
  ``torch.distributed.device_mesh.DeviceMesh`` of the same layout;
- contexts of one process (:func:`dp_mesh_from_ctx`): one replica a
  member (``Module(context=[...])``, ``Parameter.initialize(ctx=[...])``).

The spec functions of :mod:`.sharding` read only ``shape``, so a mesh
over any list of members serves them.
"""
from __future__ import annotations

import collections
import math

import numpy as np

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_EP = "ep"

#: canonical ordering, outermost first
CANONICAL_ORDER = (AXIS_PP, AXIS_DP, AXIS_EP, AXIS_SP, AXIS_TP)


class MeshSpec(collections.OrderedDict):
    """Ordered {axis_name: size} spec; -1 means "all remaining devices"."""

    def resolved(self, n_devices):
        out = collections.OrderedDict(self)
        known = 1
        wild = None
        for k, v in out.items():
            if v == -1:
                if wild is not None:
                    raise ValueError("only one axis may be -1")
                wild = k
            else:
                known *= v
        if wild is not None:
            if n_devices % known:
                raise ValueError(
                    "cannot infer axis %r: %d devices not divisible by %d"
                    % (wild, n_devices, known))
            out[wild] = n_devices // known
            known *= out[wild]
        if known != n_devices:
            raise ValueError("mesh %s needs %d devices, have %d"
                             % (dict(out), known, n_devices))
        return out


def device_mesh_shape(n_devices, dp=1, tp=1, pp=1, sp=1, ep=1):
    """Fill dp with leftover devices; validates the product."""
    fixed = tp * pp * sp * ep
    if dp == -1:
        if n_devices % fixed:
            raise ValueError("devices %d not divisible by %d"
                             % (n_devices, fixed))
        dp = n_devices // fixed
    if dp * fixed != n_devices:
        raise ValueError("dp*tp*pp*sp*ep=%d != %d devices"
                         % (dp * fixed, n_devices))
    return collections.OrderedDict(
        [(AXIS_PP, pp), (AXIS_DP, dp), (AXIS_EP, ep), (AXIS_SP, sp),
         (AXIS_TP, tp)])


class Mesh:
    """Named axes over an array of members (ranks or contexts)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of %d dims for axes %s"
                             % (self.devices.ndim, self.axis_names))
        self.shape = collections.OrderedDict(
            zip(self.axis_names, self.devices.shape))
        self._groups = {}
        self._device_mesh = None

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return "Mesh(%s)" % dict(self.shape)

    # -- process groups (rank meshes) ---------------------------------------
    def _is_rank_mesh(self):
        import torch.distributed as dist
        return dist.is_available() and dist.is_initialized() and \
            self.size == dist.get_world_size() and \
            sorted(int(r) for r in self.devices.flat) == \
            list(range(self.size))

    def coords(self, rank=None):
        """This rank's coordinate on every axis ({axis: index})."""
        if rank is None:
            rank = _this_rank()
        where = np.argwhere(
            np.vectorize(lambda r: int(r) == rank)(self.devices))
        if not len(where):
            raise ValueError("rank %d is not a member of %r" % (rank, self))
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axis):
        """The process group of ``axis`` through this rank (None when the
        axis has size 1 or there is no group: every collective on it is
        the identity)."""
        if self.shape[axis] == 1 or self.size == 1:
            return None
        if not self._is_rank_mesh():
            raise ValueError("%r is not a mesh over this job's ranks: no "
                             "process group for axis %r" % (self, axis))
        return self.device_mesh.get_group(axis)

    def axis_ranks(self, axis):
        """The global ranks along ``axis`` through this rank, in order."""
        c = self.coords()
        idx = tuple(slice(None) if a == axis else c[a]
                    for a in self.axis_names)
        return [int(r) for r in self.devices[idx]]

    @property
    def device_mesh(self):
        """The ``torch.distributed`` DeviceMesh of this rank mesh (its
        groups take the job's backend, so CUDA tensors ride NCCL where the
        backend has it)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                "cpu", torch.tensor(self.devices.astype(np.int64)),
                mesh_dim_names=self.axis_names)
        return self._device_mesh


def _this_rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def job_ranks():
    """Every rank of the job (joining the group from the environment
    first: ``base.maybe_init_distributed``); ``[0]`` without one."""
    import torch.distributed as dist
    from ..base import maybe_init_distributed
    if maybe_init_distributed():
        return list(range(dist.get_world_size()))
    return [0]


def make_mesh(axes=None, devices=None, **axis_sizes):
    """A :class:`Mesh` over ``devices`` (default: every rank of the job).

    ``axes`` may be a dict {name: size} (ordered; -1 once for "rest"), or
    pass sizes as kwargs (``make_mesh(dp=4, tp=2)``).  Axes of size 1 are
    kept so specs can always name them.
    """
    if devices is None:
        devices = job_ranks()
    devices = list(devices)
    n = len(devices)
    if axes is None:
        axes = axis_sizes or {AXIS_DP: n}
    spec = MeshSpec(axes).resolved(n)
    shape = tuple(spec.values())
    if math.prod(shape) != n:
        raise ValueError("mesh shape %s != %d devices" % (shape, n))
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(spec.keys()))


def dp_mesh_from_ctx(ctx_list):
    """A pure-``dp`` mesh over a Module/Gluon context list: the one funnel
    from ``context=[N devices]`` to replicas.  Duplicate contexts raise
    (two entries naming one device would halve the mesh without a word);
    ``gpu(i)`` must name distinct, visible cards."""
    from ..base import MXNetError
    from ..context import Context
    ctxs = [c if isinstance(c, Context) else Context(c) for c in ctx_list]
    keys = [(c.device_type, c.device_id) for c in ctxs]
    if len(set(keys)) != len(keys):
        raise MXNetError("context list resolves to duplicate devices: %s"
                         % ctxs)
    for c in ctxs:
        if c.device_type == "gpu":
            import torch
            if c.device_id >= torch.cuda.device_count():
                raise MXNetError(
                    "context %r names a card this process does not see "
                    "(%d visible)" % (c, torch.cuda.device_count()))
    return make_mesh({AXIS_DP: len(ctxs)}, devices=ctxs)


def full_mesh(devices=None, dp=-1, tp=1, pp=1, sp=1, ep=1):
    """A mesh naming all five canonical axes (unused ones size 1)."""
    if devices is None:
        devices = job_ranks()
    spec = device_mesh_shape(len(devices), dp=dp, tp=tp, pp=pp, sp=sp, ep=ep)
    return make_mesh(spec, devices=devices)
