"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer/``): the
base class, the registry, the 17 update rules of the JAX package, and
``Updater`` / ``get_updater``."""
from __future__ import annotations

from .optimizer import (DCASGD, FTML, LAMB, LANS, LARS, NAG, SGD, SGLD,
                        AdaDelta, AdaGrad, Adam, AdamW, Adamax, Ftrl, Nadam,
                        Optimizer, RMSProp, SignSGD, Signum, Updater, create,
                        get_updater, register)

__all__ = ["DCASGD", "FTML", "LAMB", "LANS", "LARS", "NAG", "SGD", "SGLD",
           "AdaDelta", "AdaGrad", "Adam", "AdamW", "Adamax", "Ftrl",
           "Nadam", "Optimizer", "RMSProp", "SignSGD", "Signum", "Updater",
           "create", "get_updater", "register"]
