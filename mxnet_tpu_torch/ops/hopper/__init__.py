"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module per TPU
kernel file of the JAX package (``mxnet_tpu/ops/pallas/``), and
``int8_dense`` for the int8 x int8 product its TPU branch left to XLA
(``mxnet_tpu/ops/nn.py``, ``quantized_dense``). Each module
holds its kernel's wrapper, launch count and plain PyTorch version; the
sources live in ``mxnet_tpu_torch/csrc/`` and are built at first use by
``_build``. Importing builds nothing."""
from __future__ import annotations

from . import conv1x1, decode_attention, flash_attention, int8_dense

__all__ = ["conv1x1", "decode_attention", "flash_attention", "int8_dense"]
