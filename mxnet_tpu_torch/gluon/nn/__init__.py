"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon/nn``): the
subset the model zoo's ResNets need, as ``torch.nn`` modules."""
from __future__ import annotations

from .basic_layers import Activation, BatchNorm, Dense, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "GlobalAvgPool2D",
           "HybridSequential", "MaxPool2D"]
