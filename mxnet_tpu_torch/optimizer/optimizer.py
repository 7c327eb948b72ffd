"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

The base :class:`Optimizer` (``rescale_grad``, ``wd``, ``clip_gradient``,
``lr_scheduler``, per-index update counts, ``lr_mult``/``wd_mult``,
``_prep_grad``), the registry (:func:`register`, :func:`create`) and the
update rules of :class:`SGD` (with momentum), :class:`Adam` and
:class:`AdamW`, carried over from the JAX package operation for operation.

The JAX package's rule ``_update_raw(p, g, states, lr, wd, t)`` is pure and
returns new arrays. Here it is a sequence of plain torch ops that updates
the weight and its states **in place** (``mul_``, ``add_``, ``sub_``), so
an 8B model's weights and Adam moments are never copied. ``torch.optim``
is not used: its Adam adds ``eps`` elsewhere and its AdamW decays the
weight before the step, not as ``p - lr * (m_hat / (sqrt(v_hat) + eps) +
wd * p)``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

_OPT_REGISTRY = {}


def register(cls):
    _OPT_REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    try:
        return _OPT_REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}") from None


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, lr_scheduler=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        # index -> parameter, for its lr_mult / wd_mult (set by Trainer)
        self.param_dict = {}
        self._index_update_count = {}

    # -- bookkeeping ------------------------------------------------------
    def _update_count(self, index):
        self._index_update_count[index] = self._index_update_count.get(index, 0) + 1
        return self._index_update_count[index]

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            t = max(self._index_update_count.values(), default=0)
            return self.lr_scheduler(t)
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self._index_update_count.get(index, 0))
        else:
            lr = self.lr
        p = self.param_dict.get(index)
        if p is not None:
            lr *= getattr(p, "lr_mult", 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        p = self.param_dict.get(index)
        if p is not None:
            wd *= getattr(p, "wd_mult", 1.0)
        return wd

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):  # pylint: disable=unused-argument
        return ()

    # -- the rule ---------------------------------------------------------
    def _update_raw(self, p, g, states, lr, wd, t):
        """Update ``p`` and ``states`` in place from the prepared gradient
        ``g`` at learning rate ``lr``, weight decay ``wd`` and update count
        ``t``."""
        raise NotImplementedError

    def _prep_grad(self, g):
        g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    # -- per-parameter API (MXNet semantics) ------------------------------
    def update(self, index, weight, grad, state):
        """Update ``weight`` (a tensor, in place) from ``grad`` and
        ``state`` (the tuple :meth:`create_state` gave), or lists of
        them."""
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self._update_one(i, w, g, s)
        else:
            self._update_one(index, weight, grad, state)

    def _update_one(self, index, weight, grad, state):
        t = self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            g = self._prep_grad(grad.to(weight.dtype))
            self._update_raw(weight, g, tuple(state or ()), lr, wd, t)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register
class SGD(Optimizer):
    """SGD with momentum (reference ``optimizer/sgd.py``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (_zeros_like(weight),)

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        if self.momentum == 0.0:
            p.sub_(lr * g)
            return
        (mom,) = states
        mom.mul_(self.momentum).sub_(lr * g)  # mom = momentum * mom - lr * g
        p.add_(mom)


def _moments(opt, g, states, t):
    """Adam's moment updates in place; returns (m_hat, v_hat)."""
    m, v = states
    m.mul_(opt.beta1).add_((1 - opt.beta1) * g)  # b1 * m + (1 - b1) * g
    v.mul_(opt.beta2).add_((1 - opt.beta2) * g * g)
    if opt.correct_bias:
        return m / (1 - opt.beta1 ** t), v / (1 - opt.beta2 ** t)
    return m, v


@register
class Adam(Optimizer):
    """Adam (reference ``optimizer/adam.py``): weight decay is added to the
    gradient, and ``epsilon`` to the square root of the corrected second
    moment."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        mhat, vhat = _moments(self, g, states, t)
        p.sub_(lr * mhat / (torch.sqrt(vhat) + self.epsilon))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (reference ``contrib/adamw``):
    ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        mhat, vhat = _moments(self, g, states, t)
        p.sub_(lr * (mhat / (torch.sqrt(vhat) + self.epsilon) + wd * p))
