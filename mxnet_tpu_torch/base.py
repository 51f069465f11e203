"""Shared error type and file helper of the PyTorch package (counterpart
of ``mxnet_tpu/base.py``'s ``MXNetError`` and ``checkpoint.atomic_write``)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "atomic_write"]


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
