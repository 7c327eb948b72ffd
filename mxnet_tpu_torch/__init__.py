"""mxnet-tpu on PyTorch and CUDA: the port of ``mxnet_tpu`` to NVIDIA
Hopper GPUs.

A package of its own beside the JAX one, which stays the reference. Plain
tensor code is PyTorch; every TPU kernel on a ported path is a kernel
written by hand for ``sm_90a`` under ``csrc/``, built at first use. Entry
points run on the GPU unless the caller passes ``device="cpu"``.

Ported so far: serving (``serve.Generator`` and the continuous-batching
``serve.ContinuousEngine`` with its ``DynamicBatcher`` and
``ServeMetrics``, on the ``pallas`` and ``int8`` rungs, every decode step
through the CUDA decode-attention kernel; the host-side ``profiler`` and
``resilience`` fault injection they report to) and single-device training (``gluon.Trainer``, ``gluon.loss``,
``optimizer``, ``lr_scheduler``; the cache-free Llama forward through the
CUDA flash-attention kernels, forward and backward), mixed-precision
training on one device (``parallel.ShardedTrainer(dtype=...)`` with the
Llama's per-layer recompute, ``amp`` and its ``LossScaler`` on
``gluon.Trainer``), ResNet training with train-mode BatchNorm in f32 and
bf16, the 17 optimizers, 15 losses, ``initializer`` and
``gluon.metric``. ``models.llama`` has both paths; ``ops.nn`` holds the
ops, ``ops.hopper`` the kernels.
"""
from __future__ import annotations

from . import (amp, config, device, gluon, initializer, lr_scheduler,
               models, optimizer, parallel, profiler, random, resilience,
               serve)
from .base import MXNetError

__all__ = ["MXNetError", "amp", "config", "device", "gluon", "initializer",
           "lr_scheduler", "models", "optimizer", "parallel", "profiler",
           "random", "resilience", "serve"]
