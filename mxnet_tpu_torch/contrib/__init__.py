"""Opt-in model rewrites of the port (counterpart of
``mxnet_tpu/contrib``): ``pallas_fuse.fuse_resnet_v1`` so far."""
from __future__ import annotations

from . import pallas_fuse

__all__ = ["pallas_fuse"]
