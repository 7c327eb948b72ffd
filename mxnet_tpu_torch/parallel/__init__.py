"""Parallel training (the one-device part of ``mxnet_tpu/parallel``):
``ShardedTrainer``, its ``ShardingRules`` and the one-device ``Mesh``."""
from __future__ import annotations

from . import functional, mesh
from .functional import ShardedTrainer, ShardingRules
from .mesh import Mesh, get_mesh, make_mesh, set_mesh

__all__ = ["functional", "mesh", "Mesh", "ShardedTrainer", "ShardingRules",
           "get_mesh", "make_mesh", "set_mesh"]
