"""Basic Gluon layers of the port, the subset ResNet needs (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``HybridSequential``, ``Dense``,
``Activation`` and ``BatchNorm`` as ``torch.nn`` modules.

Shapes are not deferred: a layer is built with its input width
(``in_units``, ``in_channels``), so its parameters exist from the start and
can be loaded before any forward. Parameters are made empty;
``get_resnet`` makes them on ``meta``, moves them to the device and
initialises them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops


class HybridSequential(nn.Sequential):
    """Stack of blocks run in order; ``add`` appends, as in Gluon. Children
    are named ``0``, ``1``, ... like the JAX package's, so parameter names
    match ``collect_params()``."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)
        return self


class Dense(nn.Module):
    """Fully-connected layer ``x @ W^T + b`` over ``x`` flattened to
    (batch, -1), as Gluon's default ``flatten=True`` does. Parameters
    ``weight`` (units, in_units) and ``bias`` (units,)."""

    def __init__(self, units, use_bias=True, in_units=0):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense: the port does not defer shapes; pass "
                             "in_units")
        self.weight = nn.Parameter(torch.empty(units, in_units))
        self.bias = nn.Parameter(torch.empty(units)) if use_bias else None

    def forward(self, x):
        return F.linear(x.reshape(x.shape[0], -1), self.weight, self.bias)

    def extra_repr(self):
        return f"{self.weight.shape[1]} -> {self.weight.shape[0]}"


class Activation(nn.Module):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, self._act_type)

    def extra_repr(self):
        return self._act_type


class BatchNorm(nn.Module):
    """Batch normalization over axis 1 with running statistics, MXNet's
    defaults (``momentum=0.9``, ``epsilon=1e-5``).

    Train mode normalizes with the batch statistics and updates the running
    ones as the JAX layer does (``basic_layers.py``): ``m * old + (1 - m) *
    batch``, with the unbiased variance; that is
    ``F.batch_norm(momentum=1 - m)``. Eval mode uses the running ones.
    ``scale=False`` is MXNet's ``fix_gamma``: gamma is taken as 1 and the
    layer has no ``weight``. ``center=False`` keeps ``bias`` (beta, zeros by
    default) as a buffer that is not trained. State names: ``weight``
    (gamma), ``bias`` (beta), ``running_mean``, ``running_var``.
    """

    def __init__(self, momentum=0.9, epsilon=1e-5, center=True, scale=True,
                 in_channels=0):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("BatchNorm: the port does not defer shapes; "
                             "pass in_channels")
        self._momentum = momentum
        self.eps = epsilon
        self.scale = scale
        self.center = center

        def empty():
            return torch.empty(in_channels)

        if scale:
            self.weight = nn.Parameter(empty())
        else:
            self.register_parameter("weight", None)
        if center:
            self.bias = nn.Parameter(empty())
        else:
            self.register_buffer("bias", empty())
        self.register_buffer("running_mean", empty())
        self.register_buffer("running_var", empty())

    def reset_parameters(self):
        """Gluon's initial values: gamma 1, beta 0, mean 0, variance 1."""
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=self.training,
                            momentum=1.0 - self._momentum, eps=self.eps)

    def extra_repr(self):
        return (f"{self.running_mean.shape[0]}, momentum={self._momentum}, "
                f"eps={self.eps}, scale={self.scale}")
