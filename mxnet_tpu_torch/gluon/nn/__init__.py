"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon/nn``): the
subset the model zoo's ResNets, BERT and the Transformer need, as
``torch.nn`` modules."""
from __future__ import annotations

from .basic_layers import (GELU, Activation, BatchNorm, Dense, Dropout,
                           Embedding, HybridSequential, LayerNorm)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Dropout",
           "Embedding", "GELU", "GlobalAvgPool2D", "HybridSequential",
           "LayerNorm", "MaxPool2D"]
