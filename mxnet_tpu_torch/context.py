"""Device naming for the PyTorch package (counterpart of
``mxnet_tpu/context.py``).

A :class:`Context` names a device the reference's way (``"cpu"`` or
``"gpu"`` and an index); ``cpu(i)`` and ``gpu(i)`` return one, and as a
``with`` block it makes its device the default of every entry point
called inside (:func:`current_context`, :func:`resolve_device`).  Every
entry point that takes a device takes a :class:`Context`, a
``torch.device`` or a string alike (:func:`as_device`).

The default device is the first CUDA card; with no card there is no
default, so an entry point that was not told where to run raises instead
of quietly running on the host.  Callers that want the CPU (the parity
tests) pass ``device="cpu"`` or ``ctx=mx.cpu()`` explicitly, or open a
scope::

    with mx.cpu():
        mod = mx.mod.Module(sym)        # binds on the host
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "default_device", "resolve_device", "as_device"]


class Context:
    """A logical device: ``Context("cpu")``, ``Context("gpu", 1)``, or any
    ``torch.device``/Context to copy.  ``device`` is its torch device."""

    _scope = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type = device_type.device
        if isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = device_type.type
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("unknown device type %r (want cpu or gpu)"
                             % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old = None

    @property
    def device(self):
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        if isinstance(other, (Context, torch.device)):
            return self.device == Context(other).device
        return NotImplemented

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __enter__(self):
        self._old = getattr(Context._scope, "value", None)
        Context._scope.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._scope.value = self._old


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    """CUDA cards this process sees."""
    return torch.cuda.device_count()


def current_context():
    """The innermost ``with Context(...)`` scope's context, else the first
    CUDA card; raises when there is neither."""
    ctx = getattr(Context._scope, "value", None)
    if ctx is not None:
        return ctx
    return Context(default_device())


def default_device():
    """``cuda:0``; raises when the process sees no CUDA card."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is visible: pass device='cpu' to run on the "
            "host explicitly")
    return torch.device("cuda", 0)


def as_device(device):
    """A :class:`Context`, ``torch.device`` or string as a
    ``torch.device`` (no default, no check that the card exists)."""
    if isinstance(device, Context):
        return device.device
    return torch.device(device)


def resolve_device(device=None):
    """``None`` -> the ``with Context`` scope's device, else
    :func:`default_device`; a :class:`Context` -> its device; anything else
    through ``torch.device`` (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        device = current_context()
    dev = as_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("device %s requested but no CUDA device is "
                         "visible" % dev)
    return dev
