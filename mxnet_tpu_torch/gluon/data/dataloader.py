"""Gluon DataLoader (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``): batches a Dataset through a
Sampler, stacked by ``default_batchify_fn`` into NDArrays on the current
context.  A background thread (``prefetch``, default 2, or
``MXTPU_DATA_PREFETCH``) stays that many batches ahead, so the host-side
gather, batchify and host-to-device copy of batch N+1 overlap the device's
work on batch N; the worker runs in the caller's ``with Context`` scope
and re-raises its exceptions where the batch is consumed.  The
reference's telemetry spans, watchdog lease and fault sites come with
those modules (S4).
"""
from __future__ import annotations

import contextlib
import os
import queue as _queue
import threading

import numpy as _np
import torch

from ... import ndarray as nd
from ...base import MXNetError
from ...context import Context, current_context
from . import sampler as _sampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays along a new first axis,
    tuples field by field, anything else through numpy."""
    if isinstance(data[0], nd.NDArray):
        return nd.NDArray(torch.stack([d._data for d in data]),
                          data[0]._device)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = _np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class _PrefetchIter:
    """A daemon thread stays ``depth`` batches ahead; ``close()`` (also on
    exhaustion, on an error and at garbage collection) stops it and drops
    the queued batches."""

    _SENTINEL = object()

    def __init__(self, make_batches, depth, ctx):
        self._q = _queue.Queue(maxsize=depth)
        self._done = False
        self._stop = threading.Event()
        # the worker closes over locals only: capturing self would make a
        # cycle and defer __del__'s cleanup to the cyclic collector
        q, stop, sentinel = self._q, self._stop, self._SENTINEL

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def work():
            try:
                with ctx if ctx is not None else contextlib.nullcontext():
                    for batch in make_batches():
                        if not put(batch):
                            return
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                put(e)
                return
            put(sentinel)

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def close(self):
        self._done = True
        q, worker = self._q, self._worker
        if q is None:
            return
        self._stop.set()
        try:
            worker.join(timeout=2.0)
        except Exception:  # noqa: BLE001 -- interpreter shutdown
            pass
        while True:
            try:
                q.get_nowait()
            except _queue.Empty:
                break
        self._q = None
        self._worker = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._q is None:
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item


def _default_prefetch():
    try:
        return int(os.environ.get("MXTPU_DATA_PREFETCH", "2"))
    except ValueError:
        return 2


class DataLoader:
    """Loads a Dataset in batches (the reference's signature)."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, prefetch=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = _sampler.RandomSampler(len(dataset))
                else:
                    sampler = _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is "
                    "specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn if batchify_fn is not None \
            else default_batchify_fn
        self._prefetch = max(0, int(prefetch if prefetch is not None
                                    else _default_prefetch()))

    def _make_batches(self):
        for batch in self._batch_sampler:
            yield self._batchify_fn([self._dataset[idx] for idx in batch])

    def __iter__(self):
        if self._prefetch == 0:
            return self._make_batches()
        try:
            # a copy: a Context keeps its enclosing scope on itself
            ctx = Context(current_context())
        except MXNetError:
            ctx = None
        return _PrefetchIter(self._make_batches, self._prefetch, ctx)

    def __len__(self):
        return len(self._batch_sampler)
