"""Device meshes (the one-device part of ``mxnet_tpu/parallel/mesh.py``).

A mesh names the devices a ``ShardedTrainer`` spreads over. The port runs
on one device so far: :func:`make_mesh` builds a mesh of one device and
raises for more (data, tensor and pipeline parallelism over several GPUs
are ROADMAP A.4).
"""
from __future__ import annotations

import math
import threading

import torch

from .. import device as _device
from ..base import MXNetError

_state = threading.local()


class Mesh:
    """``shape``: {axis name: size}; ``devices``: the torch devices, in
    row-major order of the axes."""

    def __init__(self, shape, devices):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.devices = list(devices)

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        """The mesh's one device."""
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def make_mesh(shape=None, devices=None):
    """A mesh from an axis-name -> size dict (``{"dp": 1}`` by default) over
    ``devices`` (default: the GPU, or ``"cpu"`` if asked for). Raises
    :class:`MXNetError` for a mesh of more than one device."""
    if devices is None:
        devices = [_device.resolve(None)]
    devices = [torch.device(d) if not isinstance(d, torch.device) else d
               for d in (devices if isinstance(devices, (list, tuple))
                         else [devices])]
    if shape is None:
        shape = {"dp": 1}
    total = math.prod(int(n) for n in shape.values())
    if total != 1:
        raise MXNetError(
            f"mesh shape {shape} spans {total} devices: the port's "
            "ShardedTrainer runs on one device so far (meshes of several "
            "GPUs are ROADMAP A.4)")
    if not devices:
        raise MXNetError("make_mesh: no device given")
    return Mesh(shape, devices[:1])


def set_mesh(mesh):
    _state.mesh = mesh
    return mesh


def get_mesh(create=False, device=None):
    """The mesh set on this thread; with ``create``, a new one-device mesh
    (on ``device``, default the GPU) when none is set."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None and create:
        mesh = set_mesh(make_mesh(
            devices=[_device.resolve(device)]))
    return mesh
