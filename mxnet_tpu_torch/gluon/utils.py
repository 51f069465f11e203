"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm`` and
``check_sha1``.  ``shard_and_load`` (a batch sharded over a device mesh)
belongs to the multi-device slice, and ``download`` needs a network.
"""
from __future__ import annotations

import hashlib
import math

import torch

from .. import ndarray as nd

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` into ``num_slice`` NDArrays; an
    uneven split needs ``even_split=False`` and makes the last slice the
    short one."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." %
            (str(data.shape), num_slice, batch_axis))
    if size % num_slice != 0 and even_split:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's a multiple of %d or "
            "set even_split=False to allow uneven partial slices." %
            (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice if size % num_slice == 0 \
        else int(math.ceil(size / num_slice))
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=min((i + 1) * step, size))
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` (an NDArray or anything ``nd.array`` takes) into one
    slice per context and put each slice on its context."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so their joint 2-norm is at most
    ``max_norm``; returns the norm before scaling (a host float: the
    reference reads it too)."""
    assert len(arrays) > 0
    total = torch.stack([torch.sum(torch.square(a._data.detach().float()))
                         for a in arrays]).sum()
    total_norm = math.sqrt(float(total))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr._set_data((arr * scale)._data)
    return total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash
