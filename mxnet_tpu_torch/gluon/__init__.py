"""Gluon in the port: losses as ``torch.nn`` modules, the single-device
:class:`Trainer` (counterparts of ``mxnet_tpu/gluon/loss.py`` and
``trainer.py``), the layers ResNet needs (``gluon.nn``) and the model zoo's
ResNets (``gluon.model_zoo.vision``). Models are plain ``torch.nn``
modules; the Gluon ``Block`` and ``Parameter`` layer is not ported."""
from __future__ import annotations

from . import loss, model_zoo, nn
from .trainer import Trainer

__all__ = ["loss", "model_zoo", "nn", "Trainer"]
