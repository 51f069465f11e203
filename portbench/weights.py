"""Seeded random weights, made on the device in one draw.

Matrices and biases are normal(0, 0.02), LayerNorm gains 1 and shifts 0.
All normal leaves come from one ``torch.randn`` call of a generator on
``device`` seeded with the run's seed, sliced in the order of
:func:`~portbench.reference.gpt2.param_shapes`, so the same seed gives
the same weights on the same kind of device.
"""
from __future__ import annotations

import math

import torch

from .reference.gpt2 import param_shapes

STD = 0.02


def generator(seed, device, stream=0):
    """A generator on ``device`` for ``(seed, stream)``; seeds of any size
    fold into 63 bits."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63 - 1))
    return g


def make_weights(cfg, seed, device):
    """``{name: float32 tensor}`` for ``cfg`` on ``device``."""
    shapes = param_shapes(cfg)
    normal = [n for n in shapes if not n.endswith((".g", ".b"))
              or n.endswith(("qkv.b", "out.b", "fc1.b", "fc2.b"))]
    total = sum(math.prod(shapes[n]) for n in normal)
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device, dtype=torch.float32).mul_(STD)
    out, at = {}, 0
    for n in normal:
        k = math.prod(shapes[n])
        out[n] = flat[at:at + k].view(shapes[n])
        at += k
    for n, shape in shapes.items():
        if n not in out:
            fill = 1.0 if n.endswith(".g") else 0.0
            out[n] = torch.full(shape, fill, device=device)
    return {n: out[n] for n in shapes}
