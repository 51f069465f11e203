"""The ``sym`` namespace: Symbol and every registered operator as a
creator (counterpart of ``mxnet_tpu/symbol/__init__.py``)."""
from .symbol import (Group, Symbol, Variable, load, load_json,
                     populate as _populate, var)
from . import shape_hints  # noqa: F401  (registers the shape hints)

_populate(globals())

