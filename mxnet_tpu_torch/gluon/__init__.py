"""Gluon's training surface in the port: losses as ``torch.nn`` modules and
the single-device :class:`Trainer` (counterparts of
``mxnet_tpu/gluon/loss.py`` and ``trainer.py``). Models are plain
``torch.nn`` modules (``mxnet_tpu_torch.models``); the Gluon ``Block`` and
``Parameter`` layer is not ported."""
from __future__ import annotations

from . import loss
from .trainer import Trainer

__all__ = ["loss", "Trainer"]
