"""KVStore: the parameter store (counterpart of ``mxnet_tpu/kvstore.py``).

``create('local'|'device'|'local_allreduce_device'|'local_allreduce_cpu')``
gives an in-process store with the reference's surface: ``push`` merges
(sums) the list of values given for a key, then runs the optimizer once
on the merged value against the stored weight (``set_optimizer``: the
reference's ``update_on_kvstore``) or, with no updater, stores the
merged value; ``pull`` writes the stored value into each output.

``create('dist_sync'|'dist_async'|'dist_device_sync'|'dist_sync_device')``
joins ``torch.distributed`` from the launcher's environment
(``base.maybe_init_distributed``) and gives the same store with ``rank``,
``num_workers`` and ``barrier`` on the job's group.  A push of a batch of
keys merges each key's local values, then sums them over the workers in
ONE all-reduce of a flat bucket a dtype (``_dist_allreduce``, under the
``kv.allreduce`` watchdog lease with the ``kv.hang`` fault site inside):
the ps-lite ZPush/merge/ZPull cycle of MXNet becomes the one collective,
and every worker's updater then runs on the same sum, so the workers'
weights stay bitwise equal.  ``dist_async`` is the same all-reduce, as in
the reference.  Without ``MXTPU_COORDINATOR`` a ``dist*`` store is a
world of one process (rank 0, one worker); a group that fails to form
raises.  ``set_gradient_compression({"type": "2bit", ...})`` quantizes
every push (:mod:`.gradient_compression`): a one-process store replaces
the merged gradient by its quantized image, a ``dist*`` store all-gathers
the packed codes (16 times fewer bytes than fp32) and sums the decoded
rows.  ``stats`` counts the all-reduce calls, the bytes this worker put
on the wire and the seconds spent (a plain dict: the telemetry registry
holds the reference's documented names only).  Under NCCL a CUDA bucket
goes through this rank's card (bring-up's current device), whichever card
the arrays live on.

The torch meaning of ``pull``: a COPY into each output, in place, in the
output's dtype and on its device.  The reference rebinds the output to
the store's buffer, which JAX's immutable arrays make harmless; in torch
that would alias a bound executor's argument to the store's weight,
which the updater writes in place.  The stored weight follows the
device of the gradient pushed for it (the reference's store follows the
gradient's placement the same way), so a Module on the card updates on
the card.

The reference's planes, with the same names: the ``kv.push``/``kv.pull``
spans, the ``kv.push_keys``/``kv.pull_keys`` counters and the
``kv.world_changes`` counter (a world-size change since the store was
built: the elastic membership is noted, the compression residuals
dropped); ``barrier`` runs under ``watchdog.guard("kv.barrier",
timeout=MXTPU_COLLECTIVE_TIMEOUT)`` with the ``kv.hang`` fault site
inside, so a wedged barrier becomes a diagnosed stall (exit 75); the
optimizer states save checksummed (``checkpoint.write_state_file``) and
load validated.  ``row_sparse_pull`` needs sparse storage (slice S6) and
raises.

Keys may be str or int; values are NDArrays or lists of NDArrays (one per
device), as in the reference.
"""
from __future__ import annotations

import time

from . import fault as _fault
from . import optimizer as opt
from . import telemetry as _telemetry
from . import watchdog as _watchdog
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_VALID = ("local", "device", "local_allreduce_device",
          "local_allreduce_cpu", "dist_sync", "dist_async",
          "dist_device_sync", "dist_sync_device")


def _collective_timeout():
    """Deadline of one blocking collective or barrier (None: the global
    stall timeout; ``MXTPU_COLLECTIVE_TIMEOUT`` raises it apart from the
    step lease: peers may still be building kernels)."""
    v = _watchdog._env_float("MXTPU_COLLECTIVE_TIMEOUT", 0.0)
    return v if v > 0 else None


def _flatten_pairs(key, value):
    """``(key, value)`` as ``([key...], [[value...]...])``, the reference's
    ``_ctype_key_value``."""
    if isinstance(key, (str, int)):
        if isinstance(value, (list, tuple)) and \
                all(isinstance(v, NDArray) for v in value):
            return [key], [list(value)]
        return [key], [[value]]
    assert isinstance(key, (list, tuple))
    keys, vals = [], []
    for k, v in zip(key, value):
        sk, sv = _flatten_pairs(k, v)
        keys.extend(sk)
        vals.extend(sv)
    return keys, vals


def _on_rank_card(flat):
    """``flat`` on this rank's card when NCCL carries CUDA tensors (two
    ranks may compute on one card, but NCCL takes each rank's tensors on
    its own), else ``flat`` itself."""
    from .base import dist_backend
    if flat.is_cuda and "nccl" in (dist_backend() or ""):
        import torch
        return flat.to(torch.device("cuda", torch.cuda.current_device()))
    return flat


class KVStore:
    """Parameter store with the reference's surface."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compress_params = {"type": "none"}
        self._compressor = None
        self._cached_world = None
        #: all-reduce calls, bytes this worker sent, seconds inside them
        self.stats = {"allreduce_calls": 0, "wire_bytes": 0,
                      "allreduce_s": 0.0}

    # -- identity ----------------------------------------------------------
    @property
    def type(self):
        return self._kind

    def _dist(self):
        """True for a ``dist*`` store in a job with a process group."""
        if not self._kind.startswith("dist"):
            return False
        import torch.distributed as dist
        return dist.is_available() and dist.is_initialized()

    @property
    def rank(self):
        if self._dist():
            import torch.distributed as dist
            return dist.get_rank()
        return 0

    @property
    def num_workers(self):
        if self._dist():
            import torch.distributed as dist
            return dist.get_world_size()
        return 1

    def _check_world(self):
        """When the world size changed since the store was built (an
        elastic restart re-joined at N +- k): count it
        (``kv.world_changes``), note the membership, and drop the
        compression residuals, which encode error against the old
        world's sums."""
        world = self.num_workers
        if self._cached_world is None:
            self._cached_world = world
            return
        if world == self._cached_world:
            return
        if self._compressor is not None:
            self._compressor.reset_state()
        from . import elastic as _elastic
        _elastic.note_membership(world, self.rank)
        _telemetry.counter("kv.world_changes").inc()
        self._cached_world = world

    # -- core ops ----------------------------------------------------------
    def init(self, key, value):
        """Store a copy of the (first) value of each new key; a key already
        stored keeps its value."""
        keys, vals = _flatten_pairs(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                v = vlist[0]
                self._store[k] = NDArray(v.data.detach().clone(), v._device)

    @staticmethod
    def _merge(vlist):
        """The sum of the values, a new tensor on the first one's device."""
        merged = vlist[0].data.detach().clone()
        for v in vlist[1:]:
            merged += v.data.detach().to(merged.device)
        return NDArray(merged, vlist[0]._device)

    # -- the cross-process sum ---------------------------------------------
    def _dist_allreduce(self, raws):
        """Sum a batch of local tensors over the workers: one flat bucket
        a (device, dtype), one ``all_reduce`` each, then the sums cut back
        into the tensors' shapes (new tensors, on the tensors' devices)."""
        import torch
        import torch.distributed as dist
        with _watchdog.guard("kv.allreduce", timeout=_collective_timeout()):
            _fault.stall_if("kv.hang")
            t0 = time.perf_counter()
            out = [None] * len(raws)
            buckets = {}
            for i, x in enumerate(raws):
                buckets.setdefault((x.device, x.dtype), []).append(i)
            for (dev, _), idx in buckets.items():
                flat = _on_rank_card(
                    torch.cat([raws[i].reshape(-1) for i in idx]))
                dist.all_reduce(flat)
                self.stats["allreduce_calls"] += 1
                self.stats["wire_bytes"] += flat.numel() * \
                    flat.element_size()
                flat = flat.to(dev)
                off = 0
                for i in idx:
                    n = raws[i].numel()
                    out[i] = flat[off:off + n].view(raws[i].shape)
                    off += n
            self.stats["allreduce_s"] += time.perf_counter() - t0
            return out

    def _dist_gather(self, packed):
        """``[tensor (num_workers, nbytes)]``: every worker's packed row of
        each key, by one all-gather of the concatenated rows."""
        import torch
        import torch.distributed as dist
        with _watchdog.guard("kv.allreduce", timeout=_collective_timeout()):
            _fault.stall_if("kv.hang")
            t0 = time.perf_counter()
            flat = torch.cat([p.reshape(-1) for p in packed])
            dev = flat.device
            flat = _on_rank_card(flat)
            rows = [torch.empty_like(flat) for _ in range(self.num_workers)]
            dist.all_gather(rows, flat)
            self.stats["allreduce_calls"] += 1
            self.stats["wire_bytes"] += flat.numel() * flat.element_size()
            table = torch.stack(rows).to(dev)
            out, off = [], 0
            for p in packed:
                out.append(table[:, off:off + p.numel()])
                off += p.numel()
            self.stats["allreduce_s"] += time.perf_counter() - t0
            return out

    def push(self, key, value, priority=0):
        with _telemetry.span("kv.push", cat="kvstore"):
            self._push(key, value)

    def _push(self, key, value):
        keys, vals = _flatten_pairs(key, value)
        _telemetry.counter("kv.push_keys").inc(len(keys))
        self._check_world()
        for k in keys:
            if k not in self._store:
                raise MXNetError("key %s was not initialized" % str(k))
        merged_list = [self._merge(vlist) for vlist in vals]
        if self._dist():
            # every dist push rides the group, a world of one too (its
            # all-reduce is the identity, on the job's backend)
            raws = [m.data for m in merged_list]
            if self._compressor is not None:
                summed = self._compressor.allreduce(keys, raws,
                                                    self._dist_gather)
            else:
                summed = self._dist_allreduce(raws)
            merged_list = [NDArray(s, m._device)
                           for s, m in zip(summed, merged_list)]
        elif self._compressor is not None:
            # one process: the merged gradient is replaced by its
            # quantized image, so local and distributed training see one
            # update rule
            merged_list = [NDArray(self._compressor.quantize_local(
                k, m.data), m._device) for k, m in zip(keys, merged_list)]
        for k, merged in zip(keys, merged_list):
            dst = self._store[k]
            if self._updater is None:
                self._store[k] = merged
                continue
            if dst.data.device != merged.data.device:
                # the weight follows its gradient's device
                dst._set_data(dst.data.to(merged._device))
                dst._device = merged._device
            self._updater(k, merged, dst)

    def pull(self, key, out=None, priority=0):
        """Copy each stored value into its outputs (see the module's
        docstring: never an alias of the store)."""
        assert out is not None
        with _telemetry.span("kv.pull", cat="kvstore"):
            keys, outs = _flatten_pairs(key, out)
            _telemetry.counter("kv.pull_keys").inc(len(keys))
            for k, olist in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("key %s was not initialized" % str(k))
                src = self._store[k]
                for o in olist:
                    o._assign(src.data)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError(
            "KVStore.row_sparse_pull needs sparse storage (row_sparse "
            "NDArrays), a later slice of the port (S6)")

    # -- optimizer wiring --------------------------------------------------
    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """Quantize every push to {-threshold, 0, +threshold} with per-key
        residuals (:mod:`.gradient_compression`).  Calling again with the
        same params keeps the live compressor and its residuals (a rebuild
        would drop the carried error mid-training), after the world check,
        which drops them when the world size changed since."""
        from .gradient_compression import create_compressor
        params = dict(compression_params)
        if self._compressor is not None and params == self._compress_params:
            self._check_world()
            return
        self._compress_params = params
        self._compressor = create_compressor(params)

    # -- control -----------------------------------------------------------
    def barrier(self):
        """Wait for every worker, under the scoped lease, so a barrier
        whose peer never arrives is a diagnosed stall, not an eternal hang
        (a one-element host all-reduce: the gloo side of any backend)."""
        with _watchdog.guard("kv.barrier", timeout=_collective_timeout()):
            _fault.stall_if("kv.hang")
            self._check_world()
            if self._dist() and self.num_workers > 1:
                import torch
                import torch.distributed as dist
                dist.all_reduce(torch.zeros(1))

    def _barrier_before_exit(self):
        self.barrier()

    def _send_command_to_servers(self, head, body):
        """No server processes: commands are local."""

    # -- optimizer state checkpointing -------------------------------------
    def _optimizer_states_bytes(self, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no updater")
        return self._updater.get_states(dump_optimizer=dump_optimizer)

    def _set_optimizer_states_bytes(self, payload):
        if self._updater is None:
            raise MXNetError("there is no updater")
        self._updater.set_states(payload)
        if self._optimizer is not None and \
                self._updater.optimizer is not self._optimizer:
            # a dump_optimizer save round-trips the optimizer object too
            self._optimizer = self._updater.optimizer

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Atomic, checksummed write: the same frame as the checkpoints'
        state files (``checkpoint.write_state_file``)."""
        from .checkpoint import write_state_file
        write_state_file(fname,
                         self._optimizer_states_bytes(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Validated read: a torn or corrupt state file raises
        ``MXNetError`` naming the path."""
        from .checkpoint import load_state_file
        load_state_file(fname, self._set_optimizer_states_bytes)


def create(name="local"):
    """A KVStore of kind ``name`` (reference ``kvstore.py:create``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _VALID:
        raise MXNetError("unknown KVStore type %s" % name)
    if name.startswith("dist"):
        from .base import maybe_init_distributed
        maybe_init_distributed()
    return KVStore(name)
