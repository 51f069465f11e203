"""Global random state (counterpart of ``mxnet_tpu/random.py``).

The reference seeds one JAX key chain (``mx.random.seed``) that every
random op splits.  Here each device has one ``torch.Generator``,
created at its first use and seeded from the last :func:`seed` (0 before
any); every random draw of the package on that device -- ``Dropout``, the
initializers a Gluon ``initialize`` runs, :func:`uniform`,
:func:`normal`, :func:`randint` -- takes :func:`generator` of its device,
so a run is reproducible after ``seed(n)``.  The streams are the port's
own: torch cannot reproduce threefry, so they agree with the reference's
by distribution and are pinned to themselves.
"""
from __future__ import annotations

import threading

import torch

from .context import as_device, resolve_device

__all__ = ["seed", "generator", "uniform", "normal", "randint"]

_LOCK = threading.Lock()
_SEED = 0
#: device string -> its torch.Generator
_GENERATORS = {}


def seed(seed_state):
    """Seed every device's generator (reference: ``mx.random.seed``)."""
    global _SEED
    with _LOCK:
        _SEED = int(seed_state)
        _GENERATORS.clear()


def generator(device):
    """The generator of ``device`` (a Context, ``torch.device`` or
    string), seeded from the last :func:`seed` at its first use."""
    dev = as_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _LOCK:
        gen = _GENERATORS.get(key)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_SEED)
            _GENERATORS[key] = gen
    return gen


def _draw(shape, dtype, ctx, out, fill):
    from .ndarray.ndarray import NDArray, to_torch_dtype
    dev = out._device if out is not None else resolve_device(ctx)
    shape = tuple(shape) if isinstance(shape, (list, tuple)) else \
        ((shape,) if shape else ())
    t = torch.empty(shape, dtype=to_torch_dtype(dtype), device=dev)
    fill(t, generator(dev))
    if out is None:
        return NDArray(t, dev)
    out._assign(t)
    return out


def uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
            out=None):
    """Draws from ``U[low, high)`` on ``ctx`` (or into ``out``)."""
    return _draw(shape, dtype, ctx, out,
                 lambda t, g: t.uniform_(low, high, generator=g))


def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
           out=None):
    """Draws from ``N(loc, scale^2)`` on ``ctx`` (or into ``out``)."""
    return _draw(shape, dtype, ctx, out,
                 lambda t, g: t.normal_(loc, scale, generator=g))


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    """Integers in ``[low, high)`` on ``ctx`` (or into ``out``)."""
    return _draw(shape, dtype, ctx, out,
                 lambda t, g: t.random_(low, high, generator=g))
