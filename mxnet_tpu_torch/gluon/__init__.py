"""Gluon in the port: losses as ``torch.nn`` modules, the single-device
:class:`Trainer`, the host-side metrics (counterparts of
``mxnet_tpu/gluon/loss.py``, ``trainer.py`` and ``metric.py``), the layers
ResNet, BERT and the Transformer need (``gluon.nn``) and the model zoo's
ResNets (``gluon.model_zoo.vision``). Models are plain ``torch.nn``
modules; the Gluon ``Block`` and ``Parameter`` layer is not ported."""
from __future__ import annotations

from . import loss, metric, model_zoo, nn
from .trainer import Trainer

__all__ = ["loss", "metric", "model_zoo", "nn", "Trainer"]
