"""AMP — automatic mixed precision (the port's own copy of
``mxnet_tpu/amp.py``).

AMP is a *dtype policy*: parameters stay f32 master copies, compute casts
to the low-precision dtype (bfloat16 by default) at block boundaries, and
:class:`LossScaler` gives MXNet's dynamic loss scaling for float16.

The Llama's mixed-precision training path is not this module's block
wrapper: its input is token ids, which :class:`_AmpBlock` leaves alone.
It is ``parallel.ShardedTrainer(dtype=...)``, which casts the parameters
for compute (or, under ``remat=True``, lets the model cast them at use
inside each recomputed layer).
"""
from __future__ import annotations

import math

import torch

from . import config as _config
from .base import MXNetError

_state = {"enabled": False, "dtype": None}

# ops that must stay f32 (the reference's FP32_FUNCS lists)
FP32_OPS = frozenset({
    "softmax", "log_softmax", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "ctc_loss", "norm", "mean", "sum", "exp",
    "log",
})
# ops safe in low precision (the reference's FP16_FUNCS)
TARGET_OPS = frozenset({
    "fully_connected", "convolution", "deconvolution", "batch_dot",
    "attention",
})

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def init(target_dtype="bfloat16"):
    """Enable the global AMP policy (MXNet's ``amp.init``)."""
    if target_dtype not in _DTYPES:
        raise MXNetError(f"amp target_dtype must be bfloat16/float16, got "
                         f"{target_dtype}")
    _state["enabled"] = True
    _state["dtype"] = target_dtype
    return _state["dtype"]


def is_enabled():
    return _state["enabled"]


def target_dtype():
    return _state["dtype"]


def disable():
    _state["enabled"] = False
    _state["dtype"] = None


class _AmpBlock:
    """Wrapper casting floating tensor inputs low and low-precision
    floating outputs back to f32 around a module."""

    def __init__(self, block, dtype):
        self._block = block
        self._dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype

    def __call__(self, *args):
        cast_args = [a.to(self._dtype)
                     if isinstance(a, torch.Tensor) and a.is_floating_point()
                     else a for a in args]
        out = self._block(*cast_args)

        def up(o):
            if isinstance(o, torch.Tensor) and o.dtype in (torch.bfloat16,
                                                           torch.float16):
                return o.to(torch.float32)
            return o
        if isinstance(out, tuple):
            return tuple(up(o) for o in out)
        return up(out)

    def __getattr__(self, name):
        return getattr(self._block, name)


def convert_hybrid_block(block, target_dtype="bfloat16", cast_params=False):
    """Convert a module for mixed-precision inference or training.

    ``cast_params=False`` (the default) keeps f32 master weights and casts
    activations at the boundary (:class:`_AmpBlock`); ``cast_params=True``
    casts the parameters themselves (``module.to(dtype)``: pure
    low-precision inference, half the weight bytes)."""
    if target_dtype not in _DTYPES:
        raise MXNetError("target_dtype must be bfloat16/float16")
    if cast_params:
        return block.to(_DTYPES[target_dtype])
    return _AmpBlock(block, target_dtype)


convert_model = convert_hybrid_block


class LossScaler:
    """Dynamic loss scaling (MXNet's ``contrib/amp/loss_scaler.py``):
    scale up every ``scale_window`` clean steps, halve on inf/nan.

    The scale is clamped to ``[min_scale, max_scale]`` (defaults from
    ``MXNET_LOSS_SCALE_MIN`` / ``MXNET_LOSS_SCALE_MAX``), so an overflow
    streak cannot drive it to 0 nor a long clean run to inf. Non-finite or
    non-positive values are rejected at construction and repaired in
    :meth:`update`.

    Attach to ``gluon.Trainer(loss_scaler=...)``: the trainer checks the
    gradients each step, skips the update and scales down on overflow, and
    folds the unscale into its update. ``overflows`` and ``skipped_steps``
    count trips; the trainer also bumps ``resilience.loss_scale_overflows``
    on each.
    """

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=None, max_scale=None):
        self._min = float(min_scale if min_scale is not None
                          else _config.get("MXNET_LOSS_SCALE_MIN"))
        self._max = float(max_scale if max_scale is not None
                          else _config.get("MXNET_LOSS_SCALE_MAX"))
        if not (math.isfinite(self._min) and math.isfinite(self._max)
                and 0.0 < self._min <= self._max):
            raise MXNetError(
                f"LossScaler needs 0 < min_scale <= max_scale (finite), "
                f"got [{self._min}, {self._max}]")
        if not (math.isfinite(init_scale) and init_scale > 0):
            raise MXNetError(
                f"LossScaler init_scale must be finite and > 0, got "
                f"{init_scale}")
        if not (math.isfinite(scale_factor) and scale_factor > 1.0):
            raise MXNetError(
                f"LossScaler scale_factor must be finite and > 1, got "
                f"{scale_factor}")
        self.loss_scale = self._clamp(float(init_scale))
        self._factor = float(scale_factor)
        self._window = scale_window
        self._unskipped = 0
        self.overflows = 0
        self.skipped_steps = 0

    def _clamp(self, scale):
        """Keep the scale finite, positive and inside [min, max]."""
        if not math.isfinite(scale) or scale <= 0.0:
            return self._min
        return min(max(scale, self._min), self._max)

    def scale(self, loss):
        return loss * self.loss_scale

    def unscale(self, grads):
        inv = 1.0 / self.loss_scale
        return [g * inv for g in grads]

    def has_overflow(self, grads):
        from .resilience import guardrails

        return not guardrails.all_finite(grads)

    def update(self, overflow):
        """Post-step bookkeeping; returns True if the step must be
        skipped."""
        # repair first: loss_scale is a plain attribute, so an assigned
        # bad value must not survive an update
        self.loss_scale = self._clamp(self.loss_scale)
        if overflow:
            self.overflows += 1
            self.skipped_steps += 1
            self.loss_scale = self._clamp(self.loss_scale / self._factor)
            self._unskipped = 0
            return True
        self._unskipped += 1
        if self._unskipped >= self._window:
            self.loss_scale = self._clamp(self.loss_scale * self._factor)
            self._unskipped = 0
        return False


def scale_loss(loss, scaler: LossScaler):
    """Scale one loss (or a list or tuple of them) before ``backward``."""
    if isinstance(loss, (list, tuple)):
        return type(loss)(scaler.scale(l) for l in loss)
    return scaler.scale(loss)


def list_fp16_ops():
    return sorted(TARGET_OPS)


def list_fp32_ops():
    return sorted(FP32_OPS)
