"""Shared error type, file helper and distributed bring-up of the PyTorch
package (counterpart of ``mxnet_tpu/base.py``'s ``MXNetError`` and
``_maybe_init_distributed`` and of ``checkpoint.atomic_write``).

Bring-up (:func:`maybe_init_distributed`) joins ``torch.distributed`` from
``tools/launch.py``'s environment contract (``MXTPU_COORDINATOR``,
``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_RANK``).  It runs only when asked:
from ``kv.create("dist*")`` and the ``parallel`` entry points, never at
import, because other processes of a job (the serving fleet's workers, a
script's own ``TCPStore``) live under the same contract and rank 0's
store binds the coordinator's port.  The reference's laws carry over:

- without ``MXTPU_COORDINATOR`` there is no group: the world is one
  process, rank 0;
- rank 0 whose coordinator port is taken exits ``EXIT_PORT_IN_USE`` (76),
  so the launcher re-picks the port on restart;
- a worker waits for the coordinator for ``MXTPU_CONNECT_TIMEOUT`` x
  (``MXTPU_CONNECT_RETRIES`` + 1) seconds, then raises ``MXNetError``
  naming it, instead of hanging in bring-up;
- a group that fails to form raises: nothing falls back to one process.

The backend follows the device (:func:`dist_backend`): ``nccl`` for CUDA
tensors and ``gloo`` for host tensors, or ``gloo`` for both under
``MXTPU_DIST_BACKEND=gloo``.  NCCL wants one card a rank: bring-up makes
the rank's card its current device (the ``i``-th rank of a host takes
card ``i``, where the host has one), then compares the ranks' cards and
raises ``MXNetError`` naming the flag when two share one.
"""
from __future__ import annotations

import datetime
import errno
import os
import socket
import sys
import time

__all__ = ["MXNetError", "atomic_write", "maybe_init_distributed",
           "dist_backend"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: base.py:MXNetError)."""


def atomic_write(fname, data):
    """Write ``data`` (bytes) crash-safely: to a temporary file beside
    ``fname``, fsynced, then renamed over it, so the final path never
    holds a torn file."""
    tmp = "%s.tmp.%d" % (fname, os.getpid())
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)


#: the backend string the group was formed with (None: no group)
_BACKEND = [None]


def dist_backend():
    """The backend string of the process group: ``"cpu:gloo,cuda:nccl"``
    or ``"gloo"`` (None before bring-up or without a group)."""
    return _BACKEND[0]


def _choose_backend():
    import torch
    want = os.environ.get("MXTPU_DIST_BACKEND", "").strip().lower()
    if want == "gloo":
        return want
    if want:
        raise MXNetError("MXTPU_DIST_BACKEND must be '' or 'gloo', got %r"
                         % want)
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def _split_coord(coord):
    host, _, port = coord.rpartition(":")
    return host or "127.0.0.1", int(port)


def _coordinator_port_free(coord):
    """Rank 0's pre-probe: can the coordinator port still be bound?  Only a
    live socket on the port is a conflict (SO_REUSEADDR lets a predecessor's
    TIME_WAIT debris pass); any other failure falls through to the real
    bind, which reports it."""
    try:
        host, port = _split_coord(coord)
    except ValueError:
        return True
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host if host not in ("", "localhost") else "", port))
        return True
    except OSError as e:
        return getattr(e, "errno", None) != errno.EADDRINUSE
    finally:
        s.close()


def _wait_for_coordinator(coord, deadline_s):
    """Probe the coordinator over TCP with backoff until it accepts a
    connection; raise ``MXNetError`` naming it when ``deadline_s`` runs
    out (the worker exits and the launcher restarts the job)."""
    try:
        host, port = _split_coord(coord)
    except ValueError:
        return
    deadline = time.monotonic() + max(1.0, deadline_s)
    delay, last = 0.2, None
    while time.monotonic() < deadline:
        remaining = deadline - time.monotonic()
        try:
            socket.create_connection(
                (host, port), timeout=min(5.0, max(0.5, remaining))).close()
            return
        except OSError as e:
            last = e
        time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
        delay = min(delay * 1.6, 3.0)
    raise MXNetError(
        "could not join the distributed group: coordinator %s did not "
        "accept a connection within %.0fs (last error: %s). The "
        "coordinator is dead, unreachable, or never started; exiting so "
        "the launcher can restart the job instead of hanging in bring-up "
        "forever." % (coord, deadline_s, last))


def _port_in_use_exit(coord, detail):
    from .watchdog import EXIT_PORT_IN_USE
    print("mxnet_tpu_torch: coordinator port %s is already bound (%s); "
          "exiting %d so the launcher re-picks the port (--port 0) on "
          "restart" % (coord, detail, EXIT_PORT_IN_USE),
          file=sys.stderr, flush=True)
    raise SystemExit(EXIT_PORT_IN_USE)


def _card_id():
    """This process's card as ``host/uuid`` (None on a host-only rank)."""
    import torch
    if not torch.cuda.is_available():
        return None
    idx = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    uid = getattr(props, "uuid", None)
    return "%s/%s" % (socket.gethostname(),
                      uid if uid is not None else "cuda:%d" % idx)


def _local_rank(store, rank):
    """This rank's index among the job's ranks on its host, in rank order
    (each rank publishes its host name on the store)."""
    host = socket.gethostname()
    store.set("mxtpu/host/%d" % rank, host)
    return sum(store.get("mxtpu/host/%d" % r).decode() == host
               for r in range(rank))


def _check_distinct_cards(store, backend, rank, num):
    """Under NCCL every rank needs its own card: the ``i``-th rank of a
    host takes the host's card ``i`` as its current device (where there is
    one), publishes it on the store, reads every rank's and raises
    ``MXNetError`` naming ``MXTPU_DIST_BACKEND`` when two ranks share
    one."""
    if "nccl" not in backend:
        return
    import torch
    if torch.cuda.is_available():
        local = _local_rank(store, rank)
        if local < torch.cuda.device_count():
            torch.cuda.set_device(local)
    mine = _card_id()
    store.set("mxtpu/card/%d" % rank, mine or "")
    cards = [store.get("mxtpu/card/%d" % r).decode() for r in range(num)]
    seen = {}
    for r, c in enumerate(cards):
        if c and c in seen:
            raise MXNetError(
                "ranks %d and %d share one card (%s): NCCL refuses two "
                "ranks on one device. Give each rank its own card, or set "
                "MXTPU_DIST_BACKEND=gloo to send CUDA tensors over gloo."
                % (seen[c], r, c))
        seen[c] = r


def maybe_init_distributed():
    """Join the process group from the launcher's environment contract.
    Returns True when a group of this job exists (formed now or before),
    False when there is no coordinator (a world of one process).  See the
    module's docstring for the laws."""
    import torch.distributed as dist
    coord = os.environ.get("MXTPU_COORDINATOR")
    if not coord:
        return False
    if dist.is_available() and dist.is_initialized():
        return True
    try:
        num = int(os.environ["MXTPU_NUM_WORKERS"])
        rank = int(os.environ["MXTPU_WORKER_RANK"])
    except (KeyError, ValueError) as e:
        raise MXNetError(
            "MXTPU_COORDINATOR=%s is set without a valid rank contract "
            "(MXTPU_NUM_WORKERS/MXTPU_WORKER_RANK: %s)" % (coord, e)) from e
    from .watchdog import _env_float
    t = _env_float("MXTPU_CONNECT_TIMEOUT", 0.0)
    timeout = t if t > 0 else 60.0
    retries = max(0, int(_env_float("MXTPU_CONNECT_RETRIES", 2.0)))
    window = timeout * (retries + 1)
    if rank == 0 and not _coordinator_port_free(coord):
        _port_in_use_exit(coord, "pre-bind probe failed")
    if rank != 0:
        _wait_for_coordinator(coord, window)
    backend = _choose_backend()
    host, port = _split_coord(coord)
    try:
        store = dist.TCPStore(host, port, num, rank == 0,
                              timeout=datetime.timedelta(
                                  seconds=max(300.0, window)))
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        msg = str(e).lower()
        if rank == 0 and ("address already in use" in msg or
                          "address in use" in msg):
            _port_in_use_exit(coord, e)
        raise MXNetError(
            "could not join the distributed group at %s as rank %d/%d: %s"
            % (coord, rank, num, e)) from e
    _check_distinct_cards(store, backend, rank, num)
    try:
        dist.init_process_group(
            backend, store=store, world_size=num, rank=rank,
            timeout=datetime.timedelta(seconds=max(300.0, window)))
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        raise MXNetError(
            "could not join the distributed group at %s as rank %d/%d "
            "(backend %s): %s" % (coord, rank, num, backend, e)) from e
    _BACKEND[0] = backend
    from . import elastic
    elastic.note_membership(num, rank)
    return True
