"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): the
``Loss`` base with its ``weight``/``sample_weight`` law, ``L2Loss``,
``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss``,
``KLDivLoss``, ``HuberLoss``, ``HingeLoss`` and ``CTCLoss``.

Each is a :class:`~.block.HybridBlock` of registry ops, so it takes and
returns NDArrays (or raw tensors, or Symbols) and hybridizes like any
layer.  A loss returns one value per batch element: the mean over every
axis but ``batch_axis``.  ``SoftmaxCrossEntropyLoss`` picks by the
reference's ``pick``: a label past the classes gives NaN and a negative
one counts from the end.  ``CTCLoss`` is the reference's log-semiring
forward recursion (plain jnp there), in torch ops.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "CTCLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        assert isinstance(weight, (float, int)), "weight must be a number"
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return F.Reshape(x, shape=y.shape) if hasattr(y, "shape") else x


class Loss(HybridBlock):
    """Base loss (reference loss.py:Loss)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{}(batch_axis={}, w={})".format(
            self.__class__.__name__, self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            # log(1+exp(x)) - x*z, numerically stable
            max_val = F.maximum(-pred, F.zeros_like(pred))
            loss = pred - pred * label + max_val + \
                F.log(F.exp(-max_val) + F.exp(-pred - max_val))
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label +
                     F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.maximum(self._margin - pred * label,
                         F.zeros_like(pred))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist temporal classification loss, layout ``"NTC"`` (or
    ``"TNC"``): ``pred`` ``(N, T, C)`` logits, ``label`` ``(N, L)`` padded
    with -1 (or cut by ``label_lengths``); ``pred_lengths`` limits each
    sample's frames.  ``blank_label="last"`` makes class ``C - 1`` the
    blank, anything else class 0.  Returns the negative log-likelihood
    per sample."""

    def __init__(self, layout="NTC", label_layout="NT", blank_label="last",
                 weight=None, **kwargs):
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)
        self._layout = layout
        self._label_layout = label_layout
        self._blank = blank_label

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        def raw(a):
            return a._data if isinstance(a, NDArray) else a

        p = raw(pred)
        if self._layout == "TNC":
            p = p.transpose(0, 1)
        plen, llen = raw(pred_lengths), raw(label_lengths)
        loss = ctc_loss(p, raw(label).to(torch.int64),
                        blank_last=self._blank == "last",
                        pred_lengths=plen, label_lengths=llen)
        out = NDArray(loss, loss.device) if isinstance(pred, NDArray) \
            else loss
        return _apply_weighting(F, out, self._weight, sample_weight)


def ctc_loss(logits, labels, blank_last=True, pred_lengths=None,
             label_lengths=None):
    """The CTC forward recursion in log space over time: ``logits`` ``(N,
    T, C)``, ``labels`` ``(N, L)`` int (-1 pads) -> ``(N,)`` negative
    log-likelihoods; differentiable through torch's autograd.  ``-1e30``
    stands for log 0, as in the reference."""
    n, t_len, c = logits.shape
    lab_len = labels.shape[1]
    blank = c - 1 if blank_last else 0
    dev = logits.device
    if label_lengths is not None:
        pos = torch.arange(lab_len, device=dev)[None, :]
        labels = torch.where(pos < label_lengths.to(dev)[:, None], labels,
                             torch.full_like(labels, -1))
    logp = torch.log_softmax(logits, dim=-1)
    # the extended sequence: blank l1 blank l2 ... blank (2L + 1)
    s_len = 2 * lab_len + 1
    ext = torch.full((n, s_len), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = torch.where(labels >= 0, labels,
                               torch.full_like(labels, blank))
    valid = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                       (labels >= 0).repeat_interleave(2, dim=1)], dim=1)
    label_len = (labels >= 0).sum(dim=1)
    neg_inf = -1e30
    rows = torch.arange(n, device=dev)
    alpha = torch.full((n, s_len), neg_inf, dtype=logp.dtype, device=dev)
    alpha[:, 0] = logp[:, 0, blank]
    alpha[:, 1] = torch.where(label_len > 0, logp[rows, 0, ext[:, 1]],
                              torch.full_like(alpha[:, 1], neg_inf))
    same_as_prev2 = torch.cat(
        [torch.zeros((n, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    fill1 = torch.full((n, 1), neg_inf, dtype=logp.dtype, device=dev)
    fill2 = torch.full((n, 2), neg_inf, dtype=logp.dtype, device=dev)
    alphas = [alpha]
    for step in range(1, t_len):
        shift1 = torch.cat([fill1, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([fill2, alpha[:, :-2]], dim=1)
        shift2 = torch.where(same_as_prev2, torch.full_like(shift2, neg_inf),
                             shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        emit = torch.gather(logp[:, step], 1, ext)
        alpha = torch.where(valid, merged + emit,
                            torch.full_like(merged, neg_inf))
        alphas.append(alpha)
    if pred_lengths is None:
        alpha = alphas[-1]
    else:
        t_idx = torch.clamp(pred_lengths.to(dev).to(torch.int64) - 1, 0,
                            t_len - 1)
        alpha = torch.stack(alphas)[t_idx, rows]
    a1 = torch.gather(alpha, 1, (2 * label_len)[:, None])[:, 0]
    a2 = torch.gather(alpha, 1,
                      torch.clamp(2 * label_len - 1, min=0)[:, None])[:, 0]
    a2 = torch.where(label_len > 0, a2, torch.full_like(a2, neg_inf))
    return -torch.logaddexp(a1, a2)
