"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer/``): the
base class, the registry, and SGD, Adam and AdamW so far."""
from __future__ import annotations

from .optimizer import SGD, Adam, AdamW, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register"]
