"""2-bit gradient compression (counterpart of
``mxnet_tpu/gradient_compression.py``).

Each worker keeps a per-key residual ``r``; for every element::

    v = g + r
    send  +threshold  if v >=  threshold   (code 1)
    send  -threshold  if v <= -threshold   (code 2)
    send   0          otherwise            (code 0)
    r' = v - sent

so the quantization error is carried into the next step.  Four codes
pack into a byte (element ``4i + j`` in bits ``2j``), so the wire holds
``ceil(size / 4)`` bytes where fp32 holds ``4 size``: 16 times fewer.
The cross-worker exchange all-gathers every worker's packed bytes over
the store's group, then each worker decodes every row and sums them in
fp32, in rank order, so every worker holds the same sum.  Quantizing,
packing and decoding are torch ops on the gradient's device (the
reference jits them as one XLA program each).
"""
from __future__ import annotations

import torch

__all__ = ["TwoBitCompression", "create_compressor"]

_SHIFTS = (0, 2, 4, 6)  # 4 two-bit codes per byte


def _compress_step(flat_grad, residual, threshold):
    """``(packed uint8, new residual)`` of one flat gradient."""
    v = flat_grad.to(torch.float32) + residual
    pos = v >= threshold
    neg = v <= -threshold
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.uint8)
    sent = torch.where(pos, threshold, torch.where(neg, -threshold, 0.0))
    new_residual = v - sent
    n = codes.shape[0]
    n4 = -(-n // 4) * 4
    codes = torch.nn.functional.pad(codes, (0, n4 - n)).reshape(n4 // 4, 4)
    packed = (codes[:, 0] | (codes[:, 1] << 2) |
              (codes[:, 2] << 4) | (codes[:, 3] << 6))
    return packed, new_residual


def _decode(packed, threshold, size):
    """packed uint8 (..., nbytes) -> float32 values (..., size)."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 3
    flat = bits.reshape(bits.shape[:-2] + (-1,))[..., :size]
    thr = torch.tensor(threshold, dtype=torch.float32, device=packed.device)
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    return torch.where(flat == 1, thr, torch.where(flat == 2, -thr, zero))


class TwoBitCompression:
    """2-bit quantization with residuals on the gradients' device; one
    instance serves a whole KVStore, residuals keyed by the caller."""

    type = "2bit"

    def __init__(self, threshold=0.5):
        threshold = float(threshold)
        if threshold <= 0:
            raise ValueError("2bit compression threshold must be > 0, got %s"
                             % threshold)
        self.threshold = threshold
        self._residuals = {}

    def reset_state(self):
        """Drop the error-feedback residuals: each encodes quantization
        error against a sum over one worker set, so a world-size change
        (``KVStore._check_world``) must not replay them."""
        self._residuals.clear()

    # -- local (single-process) path ------------------------------------
    def compress(self, key, data):
        """Packed uint8 codes (``ceil(size / 4)``) of ``data`` against
        key's residual, which is updated."""
        flat = data.detach().reshape(-1)
        res = self._residuals.get(key)
        if res is None or res.shape != flat.shape or \
                res.device != flat.device:
            res = torch.zeros(flat.shape, dtype=torch.float32,
                              device=flat.device)
        packed, self._residuals[key] = _compress_step(flat, res,
                                                      self.threshold)
        return packed

    def decompress(self, packed, shape, dtype):
        size = 1
        for s in shape:
            size *= int(s)
        return _decode(packed, self.threshold, size).reshape(
            tuple(shape)).to(dtype)

    def quantize_local(self, key, data):
        """compress + decompress for a one-process store: the merged
        gradient is replaced by its quantized image, residual carried."""
        return self.decompress(self.compress(key, data), data.shape,
                               data.dtype)

    # -- distributed path ------------------------------------------------
    def allreduce(self, keys, raws, gather):
        """The sum over the workers of each key's quantized gradient.

        ``gather(packed_list) -> [tensor (num_workers, nbytes)]`` moves
        every worker's packed row (the KVStore's all-gather); the rows are
        decoded and summed over the worker axis in fp32.  Returns the sums
        in each gradient's shape and dtype."""
        packed = [self.compress(k, x) for k, x in zip(keys, raws)]
        rows = gather(packed)
        out = []
        for x, r in zip(raws, rows):
            summed = _decode(r.to(x.device), self.threshold,
                             x.numel()).sum(dim=0)
            out.append(summed.reshape(x.shape).to(x.dtype))
        return out


def create_compressor(params):
    """A compressor from ``set_gradient_compression`` params (None for
    ``type`` ``"none"``)."""
    params = dict(params or {})
    ctype = params.pop("type", "none")
    if ctype in (None, "none"):
        return None
    if ctype == "2bit":
        return TwoBitCompression(threshold=params.pop("threshold", 0.5))
    raise ValueError("unsupported gradient compression type %r "
                     "(supported: 'none', '2bit')" % (ctype,))
