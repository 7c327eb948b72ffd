"""Gluon losses as ``torch.nn`` modules (counterpart of
``mxnet_tpu/gluon/loss.py``): all 15 of the JAX package's, with its
signatures and arithmetic.

Most return one loss per sample, the mean over every axis but
``batch_axis``, as MXNet does (``TripletLoss``, ``CosineEmbeddingLoss``
and ``SDMLLoss`` reduce their own axes, ``CTCLoss`` gives one per
sequence, ``PoissonNLLLoss`` the mean of everything);
``loss.sum().backward()`` then seeds the gradient with ones, as MXNet's
``loss.backward()`` does (see :class:`~mxnet_tpu_torch.gluon.Trainer`).
``weight`` scales a loss, ``sample_weight`` weighs it per element.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError


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


class L1Loss(Loss):
    """``weight * |pred - label|``, averaged over non-batch axes."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(pred - label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy; on logits (the stable
    ``max(-x, 0) + x (1 - y) + log1p(exp(-|x|))``) unless
    ``from_sigmoid``; ``pos_weight`` weighs the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            relu_neg = torch.clamp(-pred, min=0.0)
            soft = torch.log1p(torch.exp(-torch.abs(pred)))
            if pos_weight is not None:
                w = 1.0 + (pos_weight - 1.0) * label
                loss = (1.0 - label) * pred + w * (soft + relu_neg)
            else:
                loss = relu_neg + pred * (1.0 - label) + soft
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``; ``pred`` is taken as
    log-probabilities (``from_logits=True``), else log-softmaxed along
    ``axis`` first."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class CTCLoss(Loss):
    """Connectionist temporal classification, one loss per sequence.
    ``pred`` holds unnormalized scores, (N, T, C) for ``layout="NTC"`` or
    (T, N, C) for ``"TNC"``; ``label`` (N, L) (``label_layout="NT"``) or
    (L, N) (``"TN"``). The blank is the last class. Without
    ``label_lengths`` a label's length is its count of entries above 0
    (0 pads), as in the JAX package; without ``pred_lengths`` every
    sequence is T long. ``F.ctc_loss`` on the log-softmax, where the JAX
    package calls optax's forward-backward: the same function."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad layout {layout!r}")
        super().__init__(weight, 0)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        t_len, n, classes = pred.shape
        label = label.to(torch.long)
        if pred_lengths is None:
            pred_lengths = torch.full((n,), t_len, dtype=torch.long)
        if label_lengths is None:
            label_lengths = (label > 0).sum(dim=-1)
        loss = F.ctc_loss(F.log_softmax(pred.to(torch.float32), dim=-1),
                          label, pred_lengths.to(torch.long),
                          label_lengths.to(torch.long), blank=classes - 1,
                          reduction="none")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smooth L1: ``|d| - rho / 2`` beyond ``rho``, ``d^2 / (2 rho)``
    within."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        rho = self._rho
        d = torch.abs(pred - label)
        loss = torch.where(d > rho, d - 0.5 * rho, (0.5 / rho) * d * d)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.clamp(self._margin - pred * label, min=0.0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label) ** 2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(torch.clamp(self._margin - pred * label,
                                        min=0.0))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class LogisticLoss(Loss):
    """Logistic loss on logits; ``label_format`` ``"signed"`` ({-1, 1}) or
    ``"binary"`` ({0, 1})."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format!r}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = (torch.clamp(-pred, min=0.0) + pred * (1.0 - label)
                + torch.log1p(torch.exp(-torch.abs(pred))))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class TripletLoss(Loss):
    """``max(sum(|p - pos|^2 - |p - neg|^2) + margin, 0)`` over every axis
    but the first."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        d = torch.sum(torch.square(pred - positive)
                      - torch.square(pred - negative),
                      dim=tuple(range(1, pred.dim())))
        loss = torch.clamp(d + self._margin, min=0.0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, ``exp(pred) - label * pred`` on
    log-rates (``from_logits``), else ``pred - label * log(pred +
    epsilon)``; ``compute_full`` adds Stirling's term where ``label > 1``.
    Returns the mean over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = _reshape_like(pred, label)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (label * torch.log(label + 1e-12) - label
                        + 0.5 * torch.log(2.0 * math.pi * (label + 1e-12)))
            loss = loss + torch.where(label > 1, stirling, 0.0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(a, b)`` for label 1, ``max(0, cos(a, b) - margin)``
    otherwise; the cosine along the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        ab = torch.sum(input1 * input2, dim=-1)
        na = torch.sqrt(torch.sum(input1 * input1, dim=-1) + 1e-12)
        nb = torch.sqrt(torch.sum(input2 * input2, dim=-1) + 1e-12)
        cos = ab / (na * nb)
        lr = label.reshape(cos.shape)
        loss = torch.where(lr == 1, 1.0 - cos,
                           torch.clamp(cos - self._margin, min=0.0))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: each row of ``x1`` against every row
    of ``x2`` by distance, cross-entropy against the identity smoothed by
    ``smoothing_parameter``."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._sp = smoothing_parameter

    def forward(self, x1, x2):
        n = x1.shape[0]
        sp = self._sp
        dist = torch.sqrt(torch.sum(torch.square(x1[:, None, :]
                                                 - x2[None, :, :]),
                                    dim=-1) + 1e-12)
        neg_log = F.log_softmax(-dist, dim=1)
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        smoothed = (1 - sp) * eye + sp / max(n - 1, 1) * (1 - eye)
        return -torch.sum(smoothed * neg_log, dim=1)
