"""Basic Gluon layers of the port, the subset ResNet, BERT and the
Transformer need (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``):
``HybridSequential``, ``Dense``, ``Dropout``, ``Activation``, ``GELU``,
``Embedding``, ``BatchNorm`` and ``LayerNorm`` as ``torch.nn`` modules.

Shapes are not deferred: a layer is built with its input width
(``in_units``, ``in_channels``), so its parameters exist from the start and
can be loaded before any forward. Parameters are made empty; the model
factories (``get_resnet``, ``get_bert_model``, ``Transformer``) make them
on ``meta``, move them to the device and initialise them.
"""
from __future__ import annotations

import torch
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
    """Fully-connected layer ``activation(x @ W^T + b)``. With Gluon's
    default ``flatten=True`` ``x`` is flattened to (batch, -1); with
    ``flatten=False`` the product runs over the last axis. Parameters
    ``weight`` (units, in_units) and ``bias`` (units,)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense: the port does not defer shapes; pass "
                             "in_units")
        self._flatten = flatten
        self._act_type = activation
        self.weight = nn.Parameter(torch.empty(units, in_units))
        self.bias = nn.Parameter(torch.empty(units)) if use_bias else None

    def forward(self, x):
        out = _ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)
        if self._act_type:
            out = _ops.activation(out, self._act_type)
        return out

    def extra_repr(self):
        return (f"{self.weight.shape[1]} -> {self.weight.shape[0]}, "
                f"activation={self._act_type}, flatten={self._flatten}")


class Dropout(nn.Module):
    """Dropout of rate ``rate`` (``ops.nn.dropout``, on the device's seeded
    stream), active only in ``train()`` mode: the counterpart of the JAX
    layer's ``autograd.is_training()``."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return _ops.dropout(x, p=self._rate, axes=self._axes,
                            training=self.training)

    def extra_repr(self):
        return f"p={self._rate}"


class Activation(nn.Module):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, self._act_type)

    def extra_repr(self):
        return self._act_type


class GELU(nn.Module):
    """GELU, exact (``approximation="erf"``, the JAX layer's default) or
    the tanh approximation (``"tanh"``)."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        return _ops.activation(
            x, "gelu_tanh" if self._approx == "tanh" else "erf_gelu")

    def extra_repr(self):
        return f"approximation={self._approx}"


class Embedding(nn.Module):
    """Index -> vector lookup with ``weight`` (input_dim, output_dim).
    ``sparse_grad=True`` raises: the row-sparse gradient is ROADMAP A.7."""

    def __init__(self, input_dim, output_dim, sparse_grad=False):
        super().__init__()
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True): the row-sparse "
                             "gradient is ROADMAP A.7")
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim))

    def forward(self, x):
        return _ops.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.weight.shape[0]} -> {self.weight.shape[1]}"


class BatchNorm(nn.Module):
    """Batch normalization over ``axis`` (1, the channels of NCHW, by
    default) with running statistics, MXNet's defaults (``momentum=0.9``,
    ``epsilon=1e-5``); the counterpart of the JAX layer
    (``mxnet_tpu/gluon/nn/basic_layers.py``), through ``ops.nn.batch_norm``.

    Train mode (and not ``use_global_stats``) normalizes with the batch
    statistics and updates the running ones as the JAX layer does:
    ``m * old + (1 - m) * batch``, with the unbiased variance, where
    ``m * old`` is taken in the statistics' own dtype (``m`` rounded to it,
    as ``jnp`` rounds a Python scalar) and the sum in float32, the batch
    statistics' dtype. When the buffers are float32 the result is written
    in place. When a cast-for-compute step (``parallel.ShardedTrainer``)
    has handed the layer 16-bit copies of its buffers, the float32 result
    replaces the copy, and the trainer writes it back to the float32
    buffer: the old statistics are rounded to the compute dtype, the new
    ones are not. Eval mode, or ``use_global_stats``, uses the running
    ones.

    ``scale=False`` is MXNet's ``fix_gamma``: gamma is taken as 1 and the
    layer has no ``weight``. ``center=False`` keeps ``bias`` (beta, zeros by
    default) as a buffer that is not trained. State names: ``weight``
    (gamma), ``bias`` (beta), ``running_mean``, ``running_var``.
    """

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("BatchNorm: the port does not defer shapes; "
                             "pass in_channels")
        self._axis = axis
        self._momentum = momentum
        self.eps = epsilon
        self.scale = scale
        self.center = center
        self._use_global_stats = use_global_stats

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
        training = self.training and not self._use_global_stats
        out = _ops.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            eps=self.eps, fix_gamma=not self.scale,
            use_global_stats=self._use_global_stats,
            output_mean_var=training, axis=self._axis, training=training)
        if not training:
            return out
        out, mean, var = out
        with torch.no_grad():
            n = x.numel() / x.shape[self._axis]
            unbiased = var * (n / max(n - 1, 1))
            self._update("running_mean", mean)
            self._update("running_var", unbiased)
        return out

    def _update(self, name, batch):
        old = self._buffers[name]
        m = self._momentum
        new = old * torch.tensor(m, dtype=old.dtype) + (1 - m) * batch
        if new.dtype == old.dtype or old.element_size() > 2:
            old.copy_(new)
        else:
            self._buffers[name] = new

    def extra_repr(self):
        return (f"{self.running_mean.shape[0]}, axis={self._axis}, "
                f"momentum={self._momentum}, eps={self.eps}, "
                f"scale={self.scale}, "
                f"use_global_stats={self._use_global_stats}")


class LayerNorm(nn.Module):
    """Layer normalization over ``axis`` (``ops.nn.layer_norm``) with a
    learned ``gamma`` and ``beta`` of ``in_channels``."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("LayerNorm: the port does not defer shapes; "
                             "pass in_channels")
        self._axis = axis
        self._eps = epsilon
        self.gamma = nn.Parameter(torch.empty(in_channels))
        self.beta = nn.Parameter(torch.empty(in_channels))

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                               eps=self._eps)

    def extra_repr(self):
        return f"{self.gamma.shape[0]}, eps={self._eps}"
