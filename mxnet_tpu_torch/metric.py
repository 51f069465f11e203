"""Evaluation metrics (the PyTorch package's copy of
``mxnet_tpu/metric.py``): EvalMetric with get/update/reset,
CompositeEvalMetric, the classification family (Accuracy/TopK/F1),
regression losses (MAE/MSE/RMSE/CrossEntropy), Perplexity, Pearson, Loss,
Torch, Caffe, and CustomMetric/``np``; ``create()`` accepts names,
callables and lists as the reference does.

The reference computes every metric in numpy on the host.  Here Accuracy,
Perplexity, CrossEntropy, MAE, MSE, RMSE and Loss reduce in torch wherever
the predictions lie (numpy inputs are wrapped, labels follow the
predictions) and give the accumulator a Python number: a language model's
predictions on the card are ``[B, T, vocab]`` (1.65 GB at gpt2_small's
width), which the host would otherwise copy every step.  TopKAccuracy,
F1, PearsonCorrelation and CustomMetric compute in numpy on the host, as
the reference does.
"""
from __future__ import annotations

import math

import numpy
import torch

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "PearsonCorrelation", "Loss", "Torch", "Caffe", "CustomMetric",
           "np", "create"]

_METRIC_REGISTRY = {}


def _register(klass, *names):
    for n in names or (klass.__name__.lower(),):
        _METRIC_REGISTRY[n.lower()] = klass
    return klass


def check_label_shapes(labels, preds, shape=False):
    if shape:
        label_shape = sum(l.shape[0] for l in labels)
        pred_shape = sum(p.shape[0] for p in preds)
    else:
        label_shape, pred_shape = len(labels), len(preds)
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %d does not match shape of "
                         "predictions %d" % (label_shape, pred_shape))


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return numpy.asarray(x)


def _tensor(x, device=None):
    """``x`` (an NDArray, tensor or array) as a detached tensor, moved to
    ``device`` when one is given."""
    if isinstance(x, NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(numpy.asarray(x))
    x = x.detach()
    return x if device is None else x.to(device)


def _column(label, pred):
    """The regression metrics' layout: a 1-D label as a column, the
    prediction in the label's shape, both in one floating dtype."""
    if label.dim() == 1:
        label = label.reshape(label.shape[0], 1)
    dtype = torch.promote_types(label.dtype, pred.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float64
    return label.to(dtype), pred.reshape(label.shape).to(dtype)


class EvalMetric:
    """Base metric (reference metric.py:30)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference metric.py:114)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}"
                              .format(index, len(self.metrics)))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                # a numpy float32 is neither (the reference's CE or F1
                # inside a composite then fails to extend the list)
                value = [value]
            names.extend(name)
            values.extend(value)
        return names, values


@_register
class Accuracy(EvalMetric):
    """Top-1 accuracy (reference metric.py:182)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = _tensor(pred_label)
            label = _tensor(label, pred.device)
            if pred.dim() > 1 and pred.shape[-1] > 1 and \
                    pred.dim() != label.dim():
                pred = pred.argmax(dim=self.axis)
            pred = pred.to(torch.int32).reshape(-1)
            label = label.to(torch.int32).reshape(-1)
            check_label_shapes([label], [pred], shape=True)
            self.sum_metric += int((pred == label).sum())
            self.num_inst += pred.numel()


@_register
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference metric.py:231)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more " \
            "than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_np = numpy.argsort(_as_np(pred_label).astype("float32"),
                                    axis=-1)
            label_np = _as_np(label).astype("int32")
            num_samples = pred_np.shape[0]
            num_dims = len(pred_np.shape)
            assert num_dims <= 2, \
                "Predictions should be no more than 2 dims"
            if num_dims == 1:
                self.sum_metric += (pred_np.ravel() ==
                                    label_np.ravel()).sum()
            elif num_dims == 2:
                num_classes = pred_np.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (
                        pred_np[:, num_classes - 1 - j].ravel() ==
                        label_np.ravel()).sum()
            self.num_inst += num_samples


@_register
class F1(EvalMetric):
    """Binary F1 (reference metric.py:281)."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes([label], [pred_label], shape=True)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = ((pred_label == 1) & (label == 1)).sum()
            fp = ((pred_label == 1) & (label == 0)).sum()
            fn = ((pred_label == 0) & (label == 1)).sum()
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                f1 = 2 * precision * recall / (precision + recall)
            else:
                f1 = 0.0
            self.sum_metric += f1
            self.num_inst += 1


@_register
class Perplexity(EvalMetric):
    """exp(mean NLL) (reference metric.py:357)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            flat = _tensor(label, pred.device).to(torch.int32).reshape(-1)
            pred2d = pred.reshape(-1, pred.shape[-1])
            # a negative label picks from the end, as numpy's indexing
            idx = torch.where(flat < 0, flat + pred2d.shape[1], flat)
            probs = pred2d.gather(1, idx.long().view(-1, 1)).view(-1)
            if self.ignore_label is not None:
                ignore = flat == self.ignore_label
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                num -= int(ignore.sum())
            loss -= float(torch.log(torch.clamp_min(probs, 1e-10)).sum())
            num += flat.numel()
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@_register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            label, pred = _column(_tensor(label, pred.device), pred)
            self.sum_metric += float((label - pred).abs().mean())
            self.num_inst += 1


@_register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            label, pred = _column(_tensor(label, pred.device), pred)
            self.sum_metric += float(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@_register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            label, pred = _column(_tensor(label, pred.device), pred)
            self.sum_metric += float(((label - pred) ** 2.0).mean().sqrt())
            self.num_inst += 1


@_register
class CrossEntropy(EvalMetric):
    """Mean NLL of the labelled class (reference metric.py:660)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            label = _tensor(label, pred.device).reshape(-1)
            assert label.shape[0] == pred.shape[0]
            prob = pred.gather(1, label.long().view(-1, 1)).view(-1)
            self.sum_metric += float((-torch.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@_register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            self.sum_metric += numpy.corrcoef(
                pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@_register
class Loss(EvalMetric):
    """Mean of a loss output (reference metric.py:785)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            pred = _tensor(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.numel()


@_register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@_register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class CustomMetric(EvalMetric):
    """Wrap a feval(label, pred) function (reference metric.py:825)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _as_np(label)
            pred = _as_np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


_METRIC_REGISTRY["pearsonr"] = PearsonCorrelation
_METRIC_REGISTRY["acc"] = Accuracy
_METRIC_REGISTRY["ce"] = CrossEntropy
_METRIC_REGISTRY["cross-entropy"] = CrossEntropy
_METRIC_REGISTRY["top_k_accuracy"] = TopKAccuracy
_METRIC_REGISTRY["top_k_acc"] = TopKAccuracy


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Make a CustomMetric from a numpy feval (reference metric.py:895)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    """Create a metric from name / callable / list / dict."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, CompositeEvalMetric) or \
            isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        try:
            return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise ValueError("Metric must be either callable or in %s"
                             % sorted(_METRIC_REGISTRY))
    raise TypeError("metric should be either an instance of EvalMetric, "
                    "str, callable, or list")
