"""Numerical guardrails (the part of ``mxnet_tpu/resilience/guardrails.py``
that ``gluon.Trainer``'s loss-scaler path calls): :func:`all_finite`, the
overflow check, and :func:`clip_by_global_norm`. Each reduces on the
tensors' own devices and reads one value to the host per device."""
from __future__ import annotations

import math

import torch


def _by_device(tensors):
    groups = {}
    for t in tensors:
        if t is not None:
            groups.setdefault(t.device, []).append(t)
    return list(groups.values())


def all_finite(tensors) -> bool:
    """True iff every element of every tensor is finite (``None`` entries
    are skipped); stops at the first device group with a bad element."""
    for group in _by_device(tensors):
        ok = torch.stack([torch.isfinite(t).all() for t in group]).all()
        if not bool(ok):
            return False
    return True


def global_norm(tensors) -> float:
    """Global L2 norm of ``tensors``, the squares summed in f32."""
    total = 0.0
    for group in _by_device(tensors):
        total += float(sum(torch.sum(torch.square(t.to(torch.float32)))
                           for t in group))
    return math.sqrt(total)


def clip_by_global_norm(tensors, max_norm):
    """Scale ``tensors`` in place so their global L2 norm is at most
    ``max_norm``. Returns ``(tensors, norm)``, ``norm`` being the norm
    before clipping.

    A non-finite norm cannot be fixed by scaling: the tensors are left as
    they are and the caller decides (skip the step)."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    if not math.isfinite(norm) or norm <= max_norm:
        return tensors, norm
    scale = max_norm / norm
    with torch.no_grad():
        for t in tensors:
            if t is not None:
                t.mul_(scale)
    return tensors, norm
