"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/__init__.py``;
``vision`` comes with the vision slice, S3d)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
