"""Evaluation metrics (counterpart of ``mxnet_tpu/gluon/metric.py``; the
reference ``python/mxnet/gluon/metric.py``).

Host-side, on numpy, as in the JAX package: a metric takes labels and
predictions as tensors (any device and dtype; bf16 and f16 read as f32),
numpy arrays or lists, and ``get()`` returns ``(name, value)``. A copy of
the JAX module with the tensor conversion as the one change, so the port
does not import the JAX package.
"""
from __future__ import annotations

import math

import numpy as _onp
import torch

from ..base import MXNetError

_METRIC_REGISTRY = {}

# short names the reference registers via @alias (gluon/metric.py:238,
# 368, 441, 1333, 1492) so ``metric.create('acc')``-era scripts resolve
_ALIASES = {
    "composite": "compositeevalmetric",
    "acc": "accuracy",
    "top_k_accuracy": "topkaccuracy",
    "top_k_acc": "topkaccuracy",
    "ce": "crossentropy",
    "pearsonr": "pearsoncorrelation",
}


def register(cls):
    _METRIC_REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m))
        return composite
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    name = metric.lower()
    name = _ALIASES.get(name, name)
    try:
        return _METRIC_REGISTRY[name](*args, **kwargs)
    except KeyError:
        raise MXNetError(f"unknown metric {metric!r}") from None


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return _onp.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        self.update(list(label.values()), list(pred.values()))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, **kwargs)

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        self.axis = axis
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_onp.int64).ravel()
            label = label.astype(_onp.int64).ravel()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}", **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(_onp.int64).ravel()
            topk = _onp.argsort(-pred, axis=-1)[:, : self.top_k]
            hit = (topk == label[:, None]).any(axis=1)
            self.sum_metric += float(hit.sum())
            self.num_inst += len(label)


class _BinaryClassificationBase(EvalMetric):
    def reset(self):
        super().reset()
        self.tp = self.fp = self.tn = self.fn = 0

    def _count(self, labels, preds, threshold=0.5):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype(_onp.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).ravel()
            else:
                pred = (pred.ravel() > threshold).astype(_onp.int64)
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.tn += int(((pred == 0) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())


@register
class Fbeta(_BinaryClassificationBase):
    """F-beta score of a binary classification problem (reference
    ``python/mxnet/gluon/metric.py:815-871``):
    ``(1 + beta^2) * P * R / (beta^2 * P + R)``."""

    def __init__(self, name="fbeta", beta=1, threshold=0.5,
                 average="micro", **kwargs):
        self.beta = beta
        self.threshold = threshold
        self.average = average
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        self._count(labels, preds, threshold=self.threshold)
        self.num_inst = 1
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        b2 = self.beta ** 2
        self.sum_metric = ((1 + b2) * prec * rec
                           / max(b2 * prec + rec, 1e-12))


@register
class F1(Fbeta):
    """F1 is F-beta at beta=1 (the reference derives Fbeta from F1;
    sharing one update either way)."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, beta=1, average=average, **kwargs)


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy of a binary / multilabel problem at a confidence
    ``threshold`` (reference ``metric.py:876-934``)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            thr = (_to_numpy(self.threshold)
                   if isinstance(self.threshold, torch.Tensor)
                   else self.threshold)
            pred = (_to_numpy(pred) > thr).astype(_onp.int64).ravel()
            label = _to_numpy(label).astype(_onp.int64).ravel()
            if len(label) != len(pred):
                raise ValueError(
                    f"shape mismatch: {len(label)} labels vs "
                    f"{len(pred)} predictions")
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(pred)


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between label and prediction rows
    (reference ``metric.py:1197-1258``)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        self.p = p
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype(_onp.float64)
            pred = _to_numpy(pred).astype(_onp.float64)
            label = label.reshape(label.shape[0], -1)
            pred = pred.reshape(pred.shape[0], -1)
            dis = (((label - pred) ** self.p).sum(axis=-1)) ** (1. / self.p)
            self.sum_metric += float(dis.sum())
            self.num_inst += label.shape[0]


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis
    (reference ``metric.py:1263-1329``)."""

    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype(_onp.float64)
            pred = _to_numpy(pred).astype(_onp.float64)
            if label.ndim == 1:
                label = label.reshape(1, -1)
            if pred.ndim == 1:
                pred = pred.reshape(1, -1)
            sim = (label * pred).sum(axis=-1)
            n_p = _onp.linalg.norm(pred, axis=-1)
            n_l = _onp.linalg.norm(label, axis=-1)
            sim = sim / _onp.maximum(n_l * n_p, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += int(
                _onp.prod(label.shape[:-1], dtype=_onp.int64))


@register
class MCC(_BinaryClassificationBase):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        self._count(labels, preds)
        self.num_inst = 1
        num = self.tp * self.tn - self.fp * self.fn
        den = math.sqrt(
            (self.tp + self.fp) * (self.tp + self.fn)
            * (self.tn + self.fp) * (self.tn + self.fn)) or 1.0
        self.sum_metric = num / den


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        self.ignore_label = ignore_label
        self.axis = axis
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(_onp.int64)
            flat = label.ravel()
            probs = pred.reshape(-1, pred.shape[-1])[
                _onp.arange(flat.size), flat]
            if self.ignore_label is not None:
                keep = flat != self.ignore_label
                probs = probs[keep]
            self.sum_metric += float(
                -_onp.log(_onp.maximum(probs, 1e-12)).sum())
            self.num_inst += probs.size

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred).reshape(label.shape)
            self.sum_metric += float(_onp.abs(label - pred).mean()
                                     * label.shape[0])
            self.num_inst += label.shape[0]


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred).reshape(label.shape)
            self.sum_metric += float(((label - pred) ** 2).mean()
                                     * label.shape[0])
            self.num_inst += label.shape[0]


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, math.sqrt(value) if not math.isnan(value) else value


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype(_onp.int64).ravel()
            pred = _to_numpy(pred).reshape(label.size, -1)
            prob = pred[_onp.arange(label.size), label]
            self.sum_metric += float(-_onp.log(prob + self.eps).sum())
            self.num_inst += label.size


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps, name, **kwargs)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels = []
        self._preds = []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_numpy(label).ravel())
            self._preds.append(_to_numpy(pred).ravel())

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        l = _onp.concatenate(self._labels)
        p = _onp.concatenate(self._preds)
        return self.name, float(_onp.corrcoef(l, p)[0, 1])


@register
class PCC(EvalMetric):
    """Polychoric-style multiclass PCC (reference PCC metric)."""

    def __init__(self, name="pcc", **kwargs):
        self._conf = None
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._conf = None

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype(_onp.int64).ravel()
            pred = _to_numpy(pred)
            if pred.ndim > 1:
                pred = pred.argmax(-1)
            pred = pred.astype(_onp.int64).ravel()
            k = int(max(label.max(), pred.max())) + 1
            if self._conf is None or self._conf.shape[0] < k:
                newc = _onp.zeros((k, k), _onp.int64)
                if self._conf is not None:
                    rows, cols = self._conf.shape
                    newc[:rows, :cols] = self._conf
                self._conf = newc
            for li, pi in zip(label, pred):
                self._conf[pi, li] += 1
            self.num_inst += len(label)

    def get(self):
        if self._conf is None:
            return self.name, float("nan")
        c = self._conf.astype(_onp.float64)
        n = c.sum()
        pk = c.sum(0)
        tk = c.sum(1)
        num = n * _onp.trace(c) - (pk * tk).sum()
        den = math.sqrt((n * n - (pk * pk).sum())
                        * (n * n - (tk * tk).sum())) or 1.0
        return self.name, float(num / den)


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_numpy(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


@register
class Torch(Loss):  # pragma: no cover - reference legacy alias
    def __init__(self, name="torch", **kwargs):
        super().__init__(name, **kwargs)


@register
class Caffe(Loss):  # pragma: no cover - reference legacy alias
    def __init__(self, name="caffe", **kwargs):
        super().__init__(name, **kwargs)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs
        super().__init__(f"custom({name})", **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            out = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(out, tuple):
                s, n = out
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += out
                self.num_inst += 1


def np_metric(name=None, allow_extra_outputs=False):
    """Decorator creating a CustomMetric from a numpy function."""

    def deco(f):
        return CustomMetric(f, name or f.__name__, allow_extra_outputs)

    return deco


def np(numpy_feval, name=None,  # pylint: disable=invalid-name
       allow_extra_outputs=False):
    """Create a CustomMetric from a ``feval(label, pred)`` numpy function
    (reference ``gluon/metric.py:1824``; numpy itself is ``_onp`` in this
    module, so the reference's unfortunate name is safe to mirror)."""
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name or feval.__name__, allow_extra_outputs)
