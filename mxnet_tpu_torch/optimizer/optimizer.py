"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

The base :class:`Optimizer` (``rescale_grad``, ``wd``, ``clip_gradient``,
``lr_scheduler``, per-index update counts, ``lr_mult``/``wd_mult``,
``_prep_grad``, ``multi_precision`` for float16 weights), the registry
(:func:`register`, :func:`create`, the reference's aliases), the update
rules of all 17 of the JAX package's optimizers (SGD, NAG, Adam, AdamW,
RMSProp, AdaGrad, AdaDelta, Adamax, Nadam, Ftrl, FTML, Signum, LARS, LAMB,
LANS, SGLD, DCASGD), carried over operation for operation, and
:class:`Updater` / :func:`get_updater`. Row-sparse (``lazy_update``)
updates are ROADMAP A.7.

The JAX package's rule ``_update_raw(p, g, states, lr, wd, t)`` is pure and
returns new arrays. Here it is a sequence of plain torch ops that updates
the weight and its states **in place** (``mul_``, ``add_``, ``sub_``), so
an 8B model's weights and Adam moments are never copied. ``torch.optim``
is not used: its Adam adds ``eps`` elsewhere and its AdamW decays the
weight before the step, not as ``p - lr * (m_hat / (sqrt(v_hat) + eps) +
wd * p)``.
"""
from __future__ import annotations

import math
import pickle

import torch

from .. import random as _rng
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
                 learning_rate=None, lr_scheduler=None,
                 multi_precision=False):
        self.rescale_grad = rescale_grad
        self.multi_precision = multi_precision
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

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and a float16 weight: ``(f32 master
        copy, the rule's states for the master)``; else
        :meth:`create_state`."""
        if self.multi_precision and weight.dtype == torch.float16:
            master = weight.detach().to(torch.float32)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

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
            self._update_raw(weight, g, _states_tuple(state), lr, wd, t)

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, or for a float16 weight with the state of
        :meth:`create_state_multi_precision`: the rule on the f32 master
        and its states, the weight set to the master rounded to
        float16."""
        if (self.multi_precision and isinstance(state, tuple)
                and len(state) == 2 and isinstance(state[0], torch.Tensor)
                and state[0].dtype == torch.float32
                and weight.dtype == torch.float16):
            master, inner = state
            t = self._update_count(index)
            lr = self._get_lr(index)
            wd = self._get_wd(index)
            with torch.no_grad():
                g = self._prep_grad(grad.to(torch.float32))
                self._update_raw(master, g, _states_tuple(inner), lr, wd, t)
                weight.copy_(master)
        else:
            self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _states_tuple(state):
    if state is None:
        return ()
    if isinstance(state, torch.Tensor):
        return (state,)
    return tuple(state)


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


def _no_lazy(lazy_update):
    if lazy_update:
        raise MXNetError("lazy_update: row-sparse gradients are ROADMAP "
                         "A.7")


@register
class SGD(Optimizer):
    """SGD with momentum (reference ``optimizer/sgd.py``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        _no_lazy(lazy_update)
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
                 epsilon=1e-8, correct_bias=True, lazy_update=False,
                 **kwargs):
        _no_lazy(lazy_update)
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


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, learning_rate=0.1, momentum=0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return (_zeros_like(weight),)

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        (mom,) = states
        mom.mul_(self.momentum).add_(g)
        p.sub_(lr * (g + self.momentum * mom))


@register
class RMSProp(Optimizer):
    """RMSProp with momentum; ``centered`` keeps the mean gradient too;
    ``clip_weights`` clamps the weight after the step."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 2
        return tuple(_zeros_like(weight) for _ in range(n))

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        if self.centered:
            n, mg, mom = states
            n.mul_(self.rho).add_((1 - self.rho) * g * g)
            mg.mul_(self.rho).add_((1 - self.rho) * g)
            mom.mul_(self.momentum).sub_(
                lr * g / torch.sqrt(n - mg * mg + self.epsilon))
        else:
            n, mom = states
            n.mul_(self.rho).add_((1 - self.rho) * g * g)
            mom.mul_(self.momentum).sub_(
                lr * g / (torch.sqrt(n) + self.epsilon))
        p.add_(mom)
        if self.clip_weights:
            p.clamp_(-self.clip_weights, self.clip_weights)


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight),)

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        (h,) = states
        h.add_(g * g)
        p.sub_(lr * g / (torch.sqrt(h) + self.epsilon))


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        acc_g, acc_d = states
        acc_g.mul_(self.rho).add_((1 - self.rho) * g * g)
        delta = (torch.sqrt(acc_d + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon) * g)
        acc_d.mul_(self.rho).add_((1 - self.rho) * delta * delta)
        p.sub_(lr * delta)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        m, u = states
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        torch.maximum(u.mul_(self.beta2), torch.abs(g), out=u)
        lr_t = lr / (1 - self.beta1 ** t)
        p.sub_(lr_t * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum. ``m_schedule`` is host-side state that
    advances at every update call, of any parameter, as in the JAX
    package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        m, v = states
        mt = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mt1 = self.beta1 * (1 - 0.5 * 0.96 ** ((t + 1)
                                               * self.schedule_decay))
        self.m_schedule = self.m_schedule * mt
        sched1 = self.m_schedule
        sched2 = self.m_schedule * mt1
        gp = g / (1 - sched1)
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        mhat = m / (1 - sched2)
        vhat = v / (1 - self.beta2 ** t)
        mbar = (1 - mt) * gp + mt1 * mhat
        p.sub_(lr * mbar / (torch.sqrt(vhat) + self.epsilon))


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (proximal, L1 ``lamda1``)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        z, n = states
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
        z.add_(g).sub_(sigma * p)
        n.add_(g * g)
        p.copy_(torch.where(
            torch.abs(z) > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + torch.sqrt(n)) / lr + wd),
            0.0))


@register
class FTML(Optimizer):
    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        d, v, z = states
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        d_t = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(v / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d_t - self.beta1 * d
        z.mul_(self.beta1).add_((1 - self.beta1) * g).sub_(sigma * p)
        d.copy_(d_t)
        p.copy_(-z / d_t)


@register
class Signum(Optimizer):
    """Sign of the momentum (signSGD without it); ``wd_lh`` decays the
    weight outside the sign."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (_zeros_like(weight),)

    def _update_raw(self, p, g, states, lr, wd, t):
        if self.momentum == 0.0:
            p.copy_(p * (1 - lr * self.wd_lh)
                    - lr * torch.sign(g + wd * p))
            return
        (mom,) = states
        mom.mul_(self.momentum).sub_((1 - self.momentum) * (g + wd * p))
        p.copy_(p * (1 - lr * self.wd_lh) + lr * torch.sign(mom))


SignSGD = Signum


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the step of each tensor scaled by
    ``eta * |w| / (|g| + wd * |w| + eps)``."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight),)

    def _update_raw(self, p, g, states, lr, wd, t):
        (mom,) = states
        w_norm = _norm(p)
        g_norm = _norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon), 1.0)
        g = g + wd * p
        mom.mul_(self.momentum).add_(trust * lr * g)
        p.sub_(mom)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments: Adam's step scaled per tensor by
    ``|w| / |step|`` (``lower_bound``/``upper_bound`` clamp ``|w|``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        m, v = states
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        if self.bias_correction:
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * p
        w_norm = _norm(p)
        r_norm = _norm(r)
        if self.lower_bound is not None:
            w_norm = torch.clamp(w_norm, min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = torch.clamp(w_norm, max=self.upper_bound)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        p.sub_(lr * ratio * r)


@register
class LANS(Optimizer):
    """LAMB on the normalized gradient, with separate trust ratios for the
    momentum and the gradient terms."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_raw(self, p, g, states, lr, wd, t):
        g_norm = _norm(g)
        g = torch.where(g_norm > 0, g / g_norm, g)
        m, v = states
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        w_norm = _norm(p)
        r1 = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * p
        r1n = _norm(r1)
        ratio1 = torch.where((w_norm > 0) & (r1n > 0), w_norm / r1n, 1.0)
        r2 = g / (torch.sqrt(vhat) + self.epsilon) + wd * p
        r2n = _norm(r2)
        ratio2 = torch.where((w_norm > 0) & (r2n > 0), w_norm / r2n, 1.0)
        p.sub_(lr * (self.beta1 * ratio1 * r1
                     + (1 - self.beta1) * ratio2 * r2))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``p - lr / 2 * g`` plus
    gaussian noise of variance ``lr``. The noise comes from ``generator``,
    or else the weight's device stream (``mxnet_tpu_torch.random``): the
    port's own draws, not the JAX package's threefry bits."""

    def __init__(self, learning_rate=0.01, generator=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        gen = (self.generator if self.generator is not None
               else _rng.generator(p.device))
        noise = torch.randn(p.shape, dtype=p.dtype, device=p.device,
                            generator=gen) * math.sqrt(lr)
        p.copy_(p - 0.5 * lr * g + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the gradient corrected by ``lamda * g^2 *
    (w - w_prev)``; the states are the momentum and the last weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros_like(weight), weight.detach().clone())

    def _update_raw(self, p, g, states, lr, wd, t):
        g = g + wd * p
        mom, prev_w = states
        mom.mul_(self.momentum).sub_(
            lr * (g + self.lamda * g * g * (p - prev_w)))
        p.add_(mom)
        prev_w.copy_(p)


# name aliases matching the reference's create() strings
_OPT_REGISTRY.update(
    sgd=SGD, nag=NAG, adam=Adam, adamw=AdamW, rmsprop=RMSProp,
    adagrad=AdaGrad, adadelta=AdaDelta, adamax=Adamax, nadam=Nadam,
    ftrl=Ftrl, ftml=FTML, signum=Signum, signsgd=Signum, lars=LARS,
    lamb=LAMB, lans=LANS, sgld=SGLD, dcasgd=DCASGD,
)


class Updater:
    """Applies an optimizer to ``(index, grad, weight)`` triples, making
    each index's state on first use (the reference's ``updater.py``, the
    object a KVStore server runs)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        else:
            self.states[index] = _to_device(self.states[index],
                                            weight.device)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self,
                   dump_optimizer=False):  # pylint: disable=unused-argument
        """The states as a pickle of numpy arrays, in the JAX package's
        layout."""
        def to_host(s):
            if s is None:
                return None
            if isinstance(s, torch.Tensor):
                return s.detach().cpu().numpy()
            return tuple(to_host(x) for x in s)

        return pickle.dumps({k: to_host(v) for k, v in self.states.items()})

    def set_states(self, states_blob):
        """Restore :meth:`get_states`' output (only a blob this program
        wrote: it is unpickled). The states stay on the CPU until their
        index's next update moves them to its weight's device."""
        def to_tensor(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(to_tensor(x) for x in s)
            return torch.from_numpy(s)

        for k, v in pickle.loads(states_blob).items():
            self.states[k] = to_tensor(v)


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, tuple):
        return tuple(_to_device(s, device) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
