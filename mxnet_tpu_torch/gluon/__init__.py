"""Gluon: the imperative neural-network API (counterpart of
``mxnet_tpu/gluon/__init__.py``)."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from .utils import split_data, split_and_load, clip_global_norm

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "SymbolBlock", "Trainer", "nn", "loss",
           "data", "utils", "model_zoo", "split_data", "split_and_load",
           "clip_global_norm"]
