"""Operators of the reference's ``mxnet_tpu/ops/tail.py`` (its legacy
names and contrib ops), as far as the port has them:
``_contrib_flash_attention`` and its alias ``flash_attention``.

``_contrib_flash_attention`` is the flash kernels' route from the op
registry (``nd.contrib.flash_attention``, ``F._contrib_flash_attention``
in a Gluon block): it calls :func:`.flash_attention.flash_attention`, the
differentiable entry point, so on CUDA tensors its forward launches B1 and
its backward B2 + B3 (B7 under ``MXTPU_FLASH_BWD=fused``), each counted in
:data:`.flash_attention.launches`; on CPU tensors the plain versions run.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .registry import alias, register_op


@register_op("_contrib_flash_attention",
             arg_names=lambda p: (["query", "key", "value", "segments"]
                                  if p.get("use_segments")
                                  else ["query", "key", "value"]),
             param_defaults={"causal": False, "scale": None,
                             "block_q": 512, "block_k": 512,
                             "use_segments": False})
def _flash_attention_op(query, key, value, segments=None, causal=False,
                        scale=None, block_q=512, block_k=512,
                        use_segments=False):
    """Fused O(T)-memory attention over ``[B, H, T, D]``; with
    ``use_segments=True`` a fourth input, ``[B, T]`` int segment ids,
    packs sequences (a token attends within its segment).  Shape
    inference (``meta`` tensors) gets the output's shape only."""
    if query.device.type == "meta":
        return torch.empty(query.shape[:-1] + value.shape[-1:],
                           dtype=query.dtype, device=query.device)
    seg = segments.to(torch.int32) if segments is not None else None
    return flash_attention(query, key, value, causal=bool(causal),
                           scale=scale, block_q=int(block_q),
                           block_k=int(block_k), segment_ids=seg)


alias("_contrib_flash_attention", "flash_attention")
