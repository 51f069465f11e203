"""Gluon basic layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``, ``Dense``, ``Activation``, ``Dropout``,
``BatchNorm``, ``LeakyReLU``, ``Embedding``, ``FlashSelfAttention``,
``LayerNorm``, ``GELU``, ``Flatten``, ``Lambda`` and ``HybridLambda``,
every one with the reference's signature, names and deferred shapes.

Each layer's compute is one registry-op call through ``F``
(:mod:`..block`), so the same code runs eager on NDArrays, on raw
tensors, and hybridized by either route.  ``Dense`` keeps MXNet's ``[out,
in]`` weight; ``LayerNorm`` runs its statistics in at least fp32;
``FlashSelfAttention`` keeps the head-major fused qkv projection (output
rows ordered ``[H, 3, D]``, which the serving path reads) and attends
through ``F._contrib_flash_attention``, the flash kernels (B1 forward, B2
+ B3 or B7 backward).  Ring attention over a mesh
(``sequence_parallel``) belongs to the next slice of the port (S5b).
"""
from __future__ import annotations

import numpy as _np

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "FlashSelfAttention", "LayerNorm", "GELU",
           "Dropout", "BatchNorm", "LeakyReLU", "Embedding", "Flatten",
           "Lambda", "HybridLambda"]


class Sequential(Block):
    """Stack Blocks sequentially (reference basic_layers.py:29)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]

    def __iter__(self):
        return iter(self._children)


class HybridSequential(HybridBlock):
    """Stack HybridBlocks sequentially (reference basic_layers.py:53)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]

    def __iter__(self):
        return iter(self._children)


class Dense(HybridBlock):
    """Fully-connected layer (reference basic_layers.py:77)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,),
                    init=_init_from_name(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x):
        in_units = int(_np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return "Dense({0} -> {1})".format(
            self.weight.shape[1] if self.weight.shape else None,
            self._units)


class Activation(HybridBlock):
    """Activation layer (reference basic_layers.py:154)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation({})".format(self._act_type)


class Dropout(HybridBlock):
    """Dropout (reference basic_layers.py:179)."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate)

    def __repr__(self):
        return "Dropout(p = {})".format(self._rate)


class BatchNorm(HybridBlock):
    """Batch normalization (reference basic_layers.py:209)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        if in_channels != 0:
            self.in_channels = in_channels
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=_init_from_name(gamma_initializer),
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=_init_from_name(beta_initializer),
            allow_deferred_init=True)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=_init_from_name(running_mean_initializer),
            allow_deferred_init=True, differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=_init_from_name(running_variance_initializer),
            allow_deferred_init=True, differentiable=False)

    def infer_shape(self, x):
        c = x.shape[self._axis % len(x.shape)]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return "BatchNorm(axis={}, eps={}, momentum={}, in_channels={})" \
            .format(self._kwargs["axis"], self._kwargs["eps"],
                    self._kwargs["momentum"], in_channels)


class LeakyReLU(HybridBlock):
    """Leaky ReLU (reference basic_layers.py:273)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU({})".format(self._alpha)


class Embedding(HybridBlock):
    """Index → vector lookup (reference basic_layers.py:297)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "Embedding({} -> {})".format(
            self._kwargs["input_dim"], self._kwargs["output_dim"])


class FlashSelfAttention(HybridBlock):
    """Multi-head self-attention over ``[B, T, C]`` through the fused
    O(T)-memory attention op (``_contrib_flash_attention``: the flash
    kernels on the card).  ``segments`` (``[B, T]`` int ids) packs
    sequences: a token attends within its segment."""

    def __init__(self, units, num_heads, causal=False, use_bias=True,
                 weight_initializer=None, in_units=0, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             weight_initializer=weight_initializer,
                             in_units=in_units, prefix="qkv_")
            self.out_proj = Dense(units, flatten=False, use_bias=use_bias,
                                  weight_initializer=weight_initializer,
                                  in_units=units, prefix="out_")

    def hybrid_forward(self, F, x, segments=None):
        b, t = x.shape[0], x.shape[1]
        h = self._num_heads
        d = self._units // h
        qkv = self.qkv(x)                        # [B, T, 3C]
        # HEAD-MAJOR fused layout [H, 3, D], the reference's (a
        # tensor-parallel split of the qkv rows lands on whole heads)
        qkv = F.reshape(qkv, shape=(b, t, h, 3, d))
        qkv = F.transpose(qkv, axes=(3, 0, 2, 1, 4))  # [3, B, H, T, D]
        q = F.reshape(F.slice_axis(qkv, axis=0, begin=0, end=1),
                      shape=(b, h, t, d))
        k = F.reshape(F.slice_axis(qkv, axis=0, begin=1, end=2),
                      shape=(b, h, t, d))
        v = F.reshape(F.slice_axis(qkv, axis=0, begin=2, end=3),
                      shape=(b, h, t, d))
        attn = getattr(F, "_contrib_flash_attention")
        if segments is None:
            o = attn(q, k, v, causal=self._causal)  # [B, H, T, D]
        else:
            # sequence packing: [B, T] int ids, attend within-segment
            o = attn(q, k, v, segments, causal=self._causal,
                     use_segments=True)
        o = F.reshape(F.transpose(o, axes=(0, 2, 1, 3)),
                      shape=(b, t, self._units))
        return self.out_proj(o)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis``: biased variance, statistics in at
    least fp32 and the result in the input's dtype (the ``LayerNorm``
    op); ``center=False``/``scale=False`` leave ``beta``/``gamma`` out of
    training (``grad_req="null"``)."""

    def __init__(self, epsilon=1e-5, axis=-1, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,),
            init=_init_from_name(gamma_initializer),
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,),
            init=_init_from_name(beta_initializer),
            allow_deferred_init=True)

    def infer_shape(self, x):
        dim = x.shape[self._axis]
        self.gamma.shape = (dim,)
        self.beta.shape = (dim,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)

    def __repr__(self):
        return "LayerNorm(eps={}, axis={})".format(self._epsilon,
                                                   self._axis)


class GELU(HybridBlock):
    """Gaussian error linear unit (the tanh form)."""

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type="gelu")

    def __repr__(self):
        return "GELU"


class Flatten(HybridBlock):
    """Flatten to (N, -1) (reference basic_layers.py:331)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wrap a function as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            assert hasattr(nd_mod, function), \
                "Function name %s is not found in ndarray." % function
            self._func_impl = getattr(nd_mod, function)
        else:
            self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """Wrap a function as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function

            def _fn(F, *args):
                return getattr(F, function)(*args)
            self._func_impl = _fn
        else:
            self._func_impl = lambda F, *args: function(F, *args)
            self._func_name = function.__name__

    def hybrid_forward(self, F, x, *args):
        return self._func_impl(F, x, *args)


def _init_from_name(name):
    if name is None or not isinstance(name, str):
        return name
    from ... import initializer as init_mod
    return init_mod.create(name)
