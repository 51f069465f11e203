"""Named-axis collectives (counterpart of
``mxnet_tpu/parallel/collectives.py``).

Each is one ``torch.distributed`` call on the process group of a mesh
axis.  The axis is named as in the reference; the mesh is the one
:func:`~._shard_map.shard_map` runs ``fn`` under (:func:`current_mesh`),
or ``mesh=`` when called outside one.  An axis of size 1 (or a job of one
process) makes every collective the identity on this rank's value.

Where a collective's group runs gloo and the tensor lies on a card, gloo
takes all-reduce, broadcast, all-gather and reduce-scatter of the CUDA
tensor itself (probed on an H100 with torch 2.11: two ranks on one card);
it has no CUDA all-to-all, so :func:`alltoall`, and the ring's
send/recv with it, stage the tensor through host memory explicitly
(:func:`_wire`) and the result comes back to the card.
"""
from __future__ import annotations

import threading

import torch

_scope = threading.local()


def current_mesh(mesh=None):
    """``mesh``, else the mesh of the innermost ``shard_map`` call."""
    if mesh is not None:
        return mesh
    stack = getattr(_scope, "stack", None)
    if not stack:
        raise ValueError("a collective needs a mesh: call it inside "
                         "shard_map or pass mesh=")
    return stack[-1]


def push_mesh(mesh):
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    stack.append(mesh)


def pop_mesh():
    _scope.stack.pop()


def axis_index(axis, mesh=None):
    """This rank's coordinate on ``axis``."""
    m = current_mesh(mesh)
    if m.size == 1:
        return 0
    return m.coords()[axis]


def axis_size(axis, mesh=None):
    """The size of ``axis`` (a Python int)."""
    return int(current_mesh(mesh).shape[axis])


def _group(axis, mesh):
    return current_mesh(mesh).group(axis)


def _wire(x):
    """``(tensor to send, back)``: a CUDA tensor on a gloo group goes
    through host memory (for the collectives gloo runs on the host
    only)."""
    from ..base import dist_backend
    if x.is_cuda and dist_backend() == "gloo":
        return x.detach().cpu(), (lambda t: t.to(x.device))
    return x, (lambda t: t)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "mean": "SUM"}


def allreduce(x, axis, op="sum", mesh=None):
    """All-reduce over a mesh axis (the KVStore push+pull)."""
    import torch.distributed as dist
    if op not in _OPS:
        raise ValueError("unknown reduce op %r" % op)
    g = _group(axis, mesh)
    if g is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=g)
    if op == "mean":
        out = out / dist.get_world_size(g)
    return out


def allgather(x, axis, tiled_axis=0, mesh=None):
    """Gather the shards along ``tiled_axis``; the whole on every rank."""
    import torch.distributed as dist
    g = _group(axis, mesh)
    if g is None:
        return x
    send = x.detach().contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, send, group=g)
    return torch.cat(parts, dim=tiled_axis)


def reduce_scatter(x, axis, scatter_axis=0, mesh=None):
    """Sum, then scatter: rank i keeps the i-th chunk along
    ``scatter_axis`` (the ZeRO gradient primitive)."""
    import torch.distributed as dist
    g = _group(axis, mesh)
    if g is None:
        return x
    n = dist.get_world_size(g)
    chunks = [c.contiguous() for c in torch.chunk(x.detach(), n,
                                                  dim=scatter_axis)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=g)
    return out


def alltoall(x, axis, split_axis, concat_axis, mesh=None):
    """All-to-all: chunk j of ``split_axis`` goes to rank j, and the chunks
    received are concatenated along ``concat_axis`` in rank order."""
    import torch.distributed as dist
    g = _group(axis, mesh)
    if g is None:
        return x
    n = dist.get_world_size(g)
    send, back = _wire(x.detach())
    ins = [c.contiguous() for c in torch.chunk(send, n, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=g)
    return back(torch.cat(outs, dim=concat_axis))


def ring_permute(x, axis, shift=1, mesh=None):
    """Send to the neighbour ``shift`` hops around the ring and receive
    from the one ``shift`` hops back (the reference's ppermute)."""
    import torch.distributed as dist
    m = current_mesh(mesh)
    if m.shape[axis] == 1 or m.size == 1:
        return x
    ranks = m.axis_ranks(axis)
    n = len(ranks)
    i = m.coords()[axis]
    send, back = _wire(x.detach().contiguous())
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(i + shift) % n]),
        dist.P2POp(dist.irecv, recv, ranks[(i - shift) % n])])
    for r in reqs:
        r.wait()
    return back(recv)


def broadcast_from(x, axis, root=0, idx=None, mesh=None):
    """Every rank of the axis gets ``root``'s value (KVStore pull
    semantics).  ``idx`` is accepted for the reference's signature: the
    rank's own coordinate is known here."""
    import torch.distributed as dist
    m = current_mesh(mesh)
    g = m.group(axis)
    if g is None:
        return x
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=m.axis_ranks(axis)[root], group=g)
    return out
