"""Convolution and pooling Gluon layers of the port, the subset ResNet needs
(counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv2D``,
``MaxPool2D`` and ``GlobalAvgPool2D``, in Gluon's default NCHW layout.

``Conv2D``'s weight is (channels, in_channels, kh, kw), the layout of both
MXNet and PyTorch. A float32 convolution on the GPU runs with
cuDNN's TF32 off (``ops.nn.convolution``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(nn.Module):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 in_channels=0, use_bias=True):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("Conv2D: the port does not defer shapes; pass "
                             "in_channels")
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self.weight = nn.Parameter(torch.empty(channels, in_channels,
                                               *self._kernel))
        self.bias = (nn.Parameter(torch.empty(channels)) if use_bias
                     else None)

    def forward(self, x):
        return _ops.convolution(x, self.weight, self.bias, self._strides,
                                self._padding)

    def extra_repr(self):
        return (f"{self.weight.shape[1]} -> {self.weight.shape[0]}, "
                f"kernel={self._kernel}, stride={self._strides}")


class MaxPool2D(nn.Module):
    """Max pooling; padded positions never win (PyTorch pads with -inf, as
    the JAX package's ``reduce_window`` does)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0):
        super().__init__()
        self._pool = _pair(pool_size)
        self._strides = _pair(strides) if strides is not None else self._pool
        self._padding = _pair(padding)

    def forward(self, x):
        return F.max_pool2d(x, self._pool, self._strides, self._padding)


class GlobalAvgPool2D(nn.Module):
    """Mean over H and W, keeping them as 1 x 1: (N, C, 1, 1)."""

    def forward(self, x):
        return torch.mean(x, dim=(2, 3), keepdim=True)
