"""Gluon neural network layers (counterpart of
``mxnet_tpu/gluon/nn/__init__.py``; ``conv_layers`` comes with the vision
slice, S3d)."""
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__  # noqa: F401
