"""Weight initializers with the reference's name dispatch (counterpart of
``mxnet_tpu/initializer.py``, itself the MXNet initializer).

The same registry and classes: a parameter whose name ends in ``bias``,
``beta``, ``moving_mean``, ``running_mean``, ``moving_inv_var`` or
``moving_avg`` starts at 0, ``gamma``, ``moving_var`` or ``running_var``
at 1, ``upsampling`` as a bilinear kernel, ``weight`` (and a fused RNN's
``parameters``) through the initializer's own rule (:class:`Uniform`,
:class:`Normal`, :class:`Orthogonal`, :class:`Xavier`,
:class:`MSRAPrelu`, :class:`Bilinear`, :class:`LSTMBias`, :class:`Zero`,
:class:`One`, :class:`Constant`); any other name raises.  A variable's
``__init__`` attribute (an initializer's :meth:`Initializer.dumps`) picks
its own initializer, as in the reference.  :class:`Mixed` dispatches by
name pattern and :class:`Load` from saved arrays.

Two call forms: ``init(InitDesc(name, attrs), arr)``, the reference's
(``arr`` an NDArray or a tensor), and ``init(name, tensor, generator)``.
Random draws come from an explicit ``torch.Generator`` on the tensor's
device (None: torch's default generator there).  The reference draws from
JAX threefry keys, which torch cannot reproduce bit for bit, so the two
packages agree by distribution (bounds, mean and spread), not value by
value.  ``FusedRNN`` waits for the ``rnn`` package of the port.
"""
from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

from .ndarray.ndarray import NDArray

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Orthogonal",
           "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "One", "Zero",
           "Constant", "Mixed", "Load", "register", "create"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer by registered name (``"zeros"``/``"ones"`` alias
    ``"zero"``/``"one"``), or ``name`` itself if it is one."""
    if isinstance(name, Initializer):
        return name
    key = {"zeros": "zero", "ones": "one"}.get(str(name).lower(),
                                              str(name).lower())
    if key not in _REGISTRY:
        raise ValueError("Unknown initializer %r. Registered: %s"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[key](**kwargs)


class InitDesc(str):
    """A parameter's name with its symbol attributes (reference
    ``initializer.py:53``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _tensor(arr):
    return arr.data if isinstance(arr, NDArray) else arr


#: name suffix -> the family rule that fills it, in the reference's order
_FAMILIES = (("upsampling", "_init_bilinear"), ("bias", "_init_bias"),
             ("gamma", "_init_gamma"), ("beta", "_init_beta"),
             ("weight", "_init_weight"), ("parameters", "_init_weight"),
             ("moving_mean", "_init_zero"), ("running_mean", "_init_zero"),
             ("moving_var", "_init_one"), ("running_var", "_init_one"),
             ("moving_inv_var", "_init_zero"), ("moving_avg", "_init_zero"))


class Initializer:
    """Base initializer: fills ``arr`` in place by the suffix of its
    name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        if not isinstance(desc, str):
            raise TypeError("desc must be str/InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        t = _tensor(arr)
        init = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        with torch.no_grad():
            if init:
                klass, kwargs = json.loads(init)
                _REGISTRY[klass.lower()](**kwargs)._init_weight(
                    desc, t, generator)
                return
            name = desc.lower()
            for suffix, rule in _FAMILIES:
                if name.endswith(suffix):
                    getattr(self, rule)(desc, t, generator)
                    return
            self._init_default(desc, t, generator)

    # -- family defaults ---------------------------------------------------
    def _init_bilinear(self, name, arr, generator):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = _np.arange(int(_np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.astype(_np.float32).reshape(shape)))

    def _init_zero(self, name, arr, generator):
        arr.zero_()

    def _init_one(self, name, arr, generator):
        arr.fill_(1.0)

    def _init_bias(self, name, arr, generator):
        self._init_zero(name, arr, generator)

    def _init_gamma(self, name, arr, generator):
        self._init_one(name, arr, generator)

    def _init_beta(self, name, arr, generator):
        self._init_zero(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, arr, generator):
        raise ValueError(
            "Unknown initialization pattern for %s. Default "
            "initialization is limited to \"weight\", \"bias\", "
            "\"gamma\" (1.0), and \"beta\" (0.0)." % name)


@register
class Uniform(Initializer):
    """Weights uniform in ``[-scale, scale]``."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """Weights normal with mean 0 and std ``sigma``."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a uniform (or normal)
    random ``[out, prod(rest)]`` matrix (reference ``initializer.py``
    Orthogonal, SVD)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float64,
                          device=arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        res = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_((self.scale * res).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Glorot initialization: ``scale = sqrt(magnitude / factor)`` with
    ``factor`` the fan in, fan out or their mean; uniform in
    ``[-scale, scale]`` or normal with std ``scale``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to "
                             "vector %s. It requires at least 2D." % name)
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=generator)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He initialization for PReLU nets: gaussian Xavier with magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """An upsampling deconvolution's bilinear kernel."""

    def _init_weight(self, name, arr, generator):
        self._init_bilinear(name, arr, generator)


@register
class LSTMBias(Initializer):
    """An LSTM's biases at 0 but the forget gate's at ``forget_bias``
    (gates in i, f, g, o order)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        num_hidden = arr.shape[0] // 4
        arr.zero_()
        arr[num_hidden:2 * num_hidden] = self.forget_bias


@register
class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.zero_()


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.fill_(float(self.value))


class Mixed:
    """The first initializer whose pattern matches the name (reference
    ``initializer.py:226``)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have the same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise ValueError("Parameter name %s did not match any pattern"
                         % name)


class Load:
    """Initialize from saved arrays (a dict or a ``.params`` file; the
    ``arg:``/``aux:`` prefixes dropped), else through ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .context import cpu
            from .ndarray import load as nd_load
            param = nd_load(param, ctx=cpu())
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError("Parameter %s cannot be initialized from "
                                 "loading. Shape mismatch, target %s vs "
                                 "loaded %s" % (name, arr.shape, src.shape))
            with torch.no_grad():
                arr[:] = src.data if isinstance(src, NDArray) else src
        else:
            if self.default_init is None:
                raise ValueError("Cannot Initialize parameter %s" % name)
            self.default_init(name, arr, generator)
