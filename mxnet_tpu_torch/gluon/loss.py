"""Gluon losses as ``torch.nn`` modules (counterpart of
``mxnet_tpu/gluon/loss.py``).

The training slice: :class:`Loss` with its batch-axis mean,
:class:`SoftmaxCrossEntropyLoss` (``SoftmaxCELoss``) and :class:`L2Loss`.
Each returns one loss per sample, the mean over every axis but
``batch_axis``, as MXNet does; ``loss.sum().backward()`` then seeds the
gradient with ones, as MXNet's ``loss.backward()`` does (see
:class:`~mxnet_tpu_torch.gluon.Trainer`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _reshape_like(pred, label):
    if label.shape != pred.shape:
        return label.reshape(pred.shape)
    return label


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(nn.Module):
    """Base loss: scalar weighting + batch-axis mean semantics."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def __repr__(self):
        return f"{type(self).__name__}(batch_axis={self._batch_axis})"


class L2Loss(Loss):
    """``weight / 2 * (pred - label) ** 2``, averaged over non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(pred - label)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax + cross-entropy (reference SoftmaxCrossEntropyLoss).

    ``sparse_label=True`` takes class indices; otherwise one-hot or
    probabilities. With logits and sparse labels the loss is the fused
    ``logsumexp(z) - z[label]`` in f32, which never forms the
    log-probability tensor (at Llama-3's 128256-entry vocabulary that
    tensor is as large as the logits).
    """

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits and self._sparse_label:
            lse = torch.logsumexp(pred.to(torch.float32), dim=self._axis)
            picked = torch.gather(
                pred, self._axis,
                label.to(torch.long).unsqueeze(self._axis)).squeeze(
                    self._axis)
            loss = lse - picked.to(torch.float32)
        else:
            logp = (pred if self._from_logits
                    else F.log_softmax(pred, dim=self._axis))
            if self._sparse_label:
                loss = -torch.gather(
                    logp, self._axis,
                    label.to(torch.long).unsqueeze(self._axis)).squeeze(
                        self._axis)
            else:
                label = _reshape_like(logp, label)
                loss = -(logp * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
