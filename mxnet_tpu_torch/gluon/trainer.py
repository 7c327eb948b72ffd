"""Gluon Trainer on one device (counterpart of ``mxnet_tpu/gluon/trainer.py``).

Applies an :mod:`~mxnet_tpu_torch.optimizer` to a model's parameters after
a backward pass, with MXNet's semantics::

    model = get_llama("llama3_8b", num_layers=4, trainable=True)
    trainer = Trainer(model.parameters(), "adam", {"learning_rate": 1e-4})
    loss_fn = SoftmaxCrossEntropyLoss()
    loss = loss_fn(model(tokens), labels)   # (B,): one loss per sample
    loss.sum().backward()                   # MXNet's loss.backward()
    trainer.step(batch_size)                # gradients times 1 / batch_size

The trap: MXNet's ``loss.backward()`` on a per-sample loss seeds the
gradient with ones, which sums over the batch, and ``step(batch_size)``
divides by the batch size. In PyTorch that is ``loss.sum().backward()``,
not ``loss.mean().backward()``.

MXNet parameters default to ``grad_req="write"``: each backward overwrites
the gradient. PyTorch's backward adds to ``.grad``, so :meth:`step` and
:meth:`update` consume the gradients: after the update every
``param.grad`` is None, and the next backward writes fresh ones. A
parameter whose gradient is missing at the next step raises, unless
``ignore_stale_grad=True``, which skips it (the reference's stale-gradient
rule).

The trainer never moves a parameter: states are made on each parameter's
own device and every update runs there. ``allreduce_grads`` does nothing
on one device.

With an :class:`~mxnet_tpu_torch.amp.LossScaler` attached
(``loss_scaler=`` or :meth:`set_loss_scaler`), the backward runs on
``trainer.scale_loss(loss)`` and :meth:`step` checks every gradient
before the allreduce: a non-finite one skips the update (the gradients
are dropped, the weights untouched), halves the scale and bumps
``resilience.loss_scale_overflows``; a clean step clips at
``clip_global_norm`` times the scale in use and folds the unscale into
the update (``batch_size * scale``). Any of the 17 optimizers steps
through ``_update_raw`` (Nadam's host-side schedule advances once a
parameter, as on the JAX trainer's eager path); a BatchNorm's running
statistics are buffers, not parameters, and are not trained. Not ported
yet: the kvstore,
gradient compression and bucketing, and the ``trainer:grad`` /
``trainer:param`` fault sites.
"""
from __future__ import annotations

import pickle

import torch

from ..base import MXNetError
from ..optimizer import Optimizer, create as create_optimizer
from ..profiler import core as _prof
from ..resilience import counters as _counters
from ..resilience import guardrails as _guardrails


class Trainer:
    """``Trainer(params, optimizer, optimizer_params=None,
    loss_scaler=None, clip_global_norm=None)``: ``params`` is an iterable
    of tensors (such as ``model.parameters()``) or a ``{name: tensor}``
    dict; those that do not require gradients are left out, as Gluon leaves
    out ``grad_req="null"``. ``optimizer`` is a name for
    :func:`~mxnet_tpu_torch.optimizer.create` or an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer`."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 loss_scaler=None, clip_global_norm=None):
        if isinstance(params, dict):
            params = list(params.values())
        else:
            params = list(params)
        for p in params:
            if not isinstance(p, torch.Tensor):
                raise MXNetError("Trainer expects tensors (parameters), got "
                                 f"{type(p).__name__}")
        self._params = [p for p in params if p.requires_grad]
        optimizer_params = optimizer_params or {}
        self._optimizer: Optimizer = (
            create_optimizer(optimizer, **optimizer_params)
            if isinstance(optimizer, str) else optimizer)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._scale = self._optimizer.rescale_grad
        if clip_global_norm is not None and not clip_global_norm > 0:
            raise MXNetError(
                f"clip_global_norm must be > 0, got {clip_global_norm}")
        self._clip_global_norm = clip_global_norm
        self._loss_scaler = loss_scaler
        self._states = None
        self._step_count = 0

    # -- properties -------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def loss_scaler(self):
        return self._loss_scaler

    def set_loss_scaler(self, scaler):
        """Attach (or detach with ``None``) an ``amp.LossScaler``."""
        self._loss_scaler = scaler

    def scale_loss(self, loss):
        """Scale one loss (or a list) by the attached scaler before
        ``backward``; the loss itself when no scaler is attached."""
        if self._loss_scaler is None:
            return loss
        from ..amp import scale_loss as _scale

        return _scale(loss, self._loss_scaler)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- state ------------------------------------------------------------
    def _init_states(self):
        if self._states is None:
            with torch.no_grad():
                self._states = [self._optimizer.create_state(i, p.detach())
                                for i, p in enumerate(self._params)]

    # -- core step --------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Allreduce the gradients (nothing to do on one device), clip them
        to ``clip_global_norm`` if set, then update every parameter with
        gradients scaled by ``rescale_grad / batch_size``. With a loss
        scaler, an overflow skips all of it (see the module docstring)."""
        scaler = self._loss_scaler
        if scaler is not None:
            # the scale the backward used, before update() may grow it
            cur_scale = scaler.loss_scale
            # checked before the allreduce, as in the JAX package
            overflow = not _guardrails.all_finite(
                [p.grad for p in self._params])
            if scaler.update(overflow):
                _counters.incr("resilience.loss_scale_overflows")
                if _prof.ENABLED:
                    _prof.record_instant(
                        "resilience::loss_scale(overflow)", "resilience",
                        args={"new_scale": scaler.loss_scale})
                # the gradients are garbage: drop them, so the next
                # backward writes fresh ones instead of adding to them
                for p in self._params:
                    p.grad = None
                return
            self.allreduce_grads()
            self._apply_global_clip(scale_factor=cur_scale)
            # the unscale folds into the update's one multiply
            self._update(batch_size * cur_scale, ignore_stale_grad)
            return
        self.allreduce_grads()
        self._apply_global_clip()
        self._update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across devices: a single-device trainer has
        nothing to sum."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update alone (after :meth:`allreduce_grads`)."""
        self._update(batch_size, ignore_stale_grad)

    def _grads(self, ignore_stale_grad):
        stale = [i for i, p in enumerate(self._params) if p.grad is None]
        if stale and not ignore_stale_grad:
            raise MXNetError(
                f"Trainer.step: {len(stale)} parameter(s) (indices "
                f"{stale[:8]}) have no gradient since the last step; call "
                "backward first, or pass ignore_stale_grad=True to skip "
                "them")
        return [p.grad for p in self._params]

    def _apply_global_clip(self, scale_factor=1.0):
        """Scale every gradient so their global L2 norm is at most
        ``clip_global_norm`` (the raw, batch-summed gradients, as in the
        JAX package) times ``scale_factor``, the loss scale the gradients
        still carry. A non-finite norm leaves them untouched."""
        if self._clip_global_norm is None:
            return
        _guardrails.clip_by_global_norm(
            [p.grad for p in self._params if p.grad is not None],
            self._clip_global_norm * scale_factor)

    def _update(self, batch_size, ignore_stale_grad=False):
        grads = self._grads(ignore_stale_grad)
        self._init_states()
        scale = self._scale / batch_size
        opt = self._optimizer
        self._step_count += 1
        t = self._step_count
        for i in range(len(self._params)):
            opt._index_update_count[i] = t
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(self._params, grads)):
                if g is None:
                    continue
                # rescale, then clip: Optimizer._prep_grad's order
                g = g.to(p.dtype) * scale
                if opt.clip_gradient is not None:
                    g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
                opt._update_raw(p, g, self._states[i], opt._get_lr(i),
                                opt._get_wd(i), t)
                p.grad = None

    # -- persistence ------------------------------------------------------
    def save_states(self, fname):
        """Write the optimizer states and step count to ``fname``, in the
        JAX package's format (a pickle of ``{"step", "states": [[numpy
        arrays] per parameter]}``)."""
        self._init_states()
        blob = {"step": self._step_count,
                "states": [[s.detach().cpu().numpy() for s in st]
                           for st in self._states]}
        with open(fname, "wb") as f:
            pickle.dump(blob, f)

    def load_states(self, fname):
        """Restore what :meth:`save_states` wrote, into the existing states
        on their own devices. Only load files this program wrote: they are
        unpickled."""
        self._init_states()
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        if len(blob["states"]) != len(self._states):
            raise MXNetError(f"load_states: {len(blob['states'])} states for "
                             f"{len(self._states)} parameters")
        self._step_count = blob["step"]
        with torch.no_grad():
            for st, arrs in zip(self._states, blob["states"]):
                for s, a in zip(st, arrs):
                    s.copy_(torch.from_numpy(a))
