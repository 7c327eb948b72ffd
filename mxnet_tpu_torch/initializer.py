"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``; the
reference ``python/mxnet/initializer.py``).

An initializer fills a tensor in place, given the parameter's name:
``init(name, tensor)``. Names are the JAX package's (Gluon's): a name
ending in ``gamma`` gets 1, ``beta`` or ``bias`` 0, ``running_mean`` /
``moving_mean`` 0, ``running_var`` / ``moving_var`` 1, and every other
name the initializer's own rule. :func:`initialize` walks a model of the
port and gives each tensor its Gluon name first: the port's BatchNorm
keeps gamma and beta as ``weight`` and ``bias``, which become ``gamma``
and ``beta`` (as ``load_reference_params`` maps them), so Xavier never
fills a gamma with random numbers.

Random rules draw from an explicit ``torch.Generator``: the one passed,
or else the tensor's device stream (``mxnet_tpu_torch.random``). Their
distributions are the JAX package's; the bits are not threefry's.
"""
from __future__ import annotations

import json
import math
import re

import numpy as _onp
import torch

from . import random as _rng
from .base import MXNetError

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"unknown initializer {name!r}") from None


class Initializer:
    """Base initializer; ``init(name, tensor, generator=None)`` fills
    ``tensor`` in place by the name rule above."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, generator=None):
        self.init_weight(name, arr, generator)

    def init_weight(self, name, arr, generator=None):
        if name is None:
            name = ""
        with torch.no_grad():
            if name.endswith("gamma"):
                arr.fill_(1)
            elif name.endswith("beta") or name.endswith("bias"):
                arr.zero_()
            elif name.endswith(("running_mean", "moving_mean")):
                arr.zero_()
            elif name.endswith(("running_var", "moving_var")):
                arr.fill_(1)
            else:
                self._init_weight(name, arr, _generator(arr, generator))

    def _init_weight(self, name, arr, gen):
        raise NotImplementedError

    def dumps(self):
        """``'["<name>", {<kwargs>}]'``, the reference's serialized form."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


def _generator(arr, generator):
    return generator if generator is not None else _rng.generator(
        arr.device)


def _fans(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _fill(arr, draw):
    """Fill ``arr`` with ``draw(float_tensor)``: the draw runs in the
    tensor's own dtype when it is floating, else in float32."""
    if arr.is_floating_point():
        draw(arr)
    else:
        tmp = torch.empty(arr.shape, dtype=torch.float32, device=arr.device)
        draw(tmp)
        arr.copy_(tmp)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr, gen):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, name, arr, gen):
        arr.fill_(1)


@register
class Constant(Initializer):
    """Every element ``value`` (a number, or a tensor broadcast to the
    shape)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, gen):
        v = self.value
        if isinstance(v, torch.Tensor):
            arr.copy_(torch.broadcast_to(v.to(arr.device), arr.shape))
        elif isinstance(v, _onp.ndarray):
            arr.copy_(torch.broadcast_to(torch.from_numpy(v), arr.shape))
        else:
            arr.fill_(v)


@register
class Uniform(Initializer):
    """U(-scale, scale); Gluon's default initializer at scale 0.07."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, gen):
        _fill(arr, lambda t: t.uniform_(-self.scale, self.scale,
                                        generator=gen))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, gen):
        _fill(arr, lambda t: t.normal_(0.0, self.sigma, generator=gen))


@register
class Orthogonal(Initializer):
    """``scale`` times the first rows and columns of a Haar-random
    orthogonal matrix of side max(rows, columns), the weight seen as
    (shape[0], the rest). ``rand_type`` is kept for the reference's
    signature, as in the JAX package."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, arr, gen):
        rows = arr.shape[0]
        cols = math.prod(arr.shape[1:]) if arr.dim() > 1 else 1
        n = max(rows, cols)
        a = torch.empty(n, n, dtype=torch.float32, device=arr.device)
        a.normal_(0.0, 1.0, generator=gen)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        arr.copy_((self.scale * q[:rows, :cols]).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Glorot: scale ``sqrt(magnitude / factor)``, the factor the average
    (``"avg"``), input (``"in"``) or output (``"out"``) fan of an
    (out, in, kernel...) weight; uniform in +-scale or gaussian of that
    standard deviation."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _scale(self, shape):
        fan_in, fan_out = _fans(shape)
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"bad factor_type {self.factor_type!r}")
        return math.sqrt(self.magnitude / max(factor, 1.0))

    def _init_weight(self, name, arr, gen):
        scale = self._scale(tuple(arr.shape))
        if self.rnd_type == "uniform":
            _fill(arr, lambda t: t.uniform_(-scale, scale, generator=gen))
        elif self.rnd_type == "gaussian":
            _fill(arr, lambda t: t.normal_(0.0, scale, generator=gen))
        else:
            raise MXNetError(f"bad rnd_type {self.rnd_type!r}")


@register
class MSRAPrelu(Xavier):
    """He et al.: gaussian Xavier at magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, kh, kw) deconvolution
    weight, as the JAX package computes it."""

    def _init_weight(self, name, arr, gen):
        shape = tuple(arr.shape)
        weight = _onp.zeros(shape, dtype="float32")
        f = shape[3] / 2.0
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_onp.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr.copy_(torch.from_numpy(weight))


@register
class LSTMBias(Initializer):
    """An LSTM bias of four gates: 0, with the forget gate's quarter at
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, gen):
        b = _onp.zeros(tuple(arr.shape), "float32")
        num_hidden = arr.shape[0] // 4
        b[num_hidden: 2 * num_hidden] = self.forget_bias
        arr.copy_(torch.from_numpy(b))


@register
class Mixed(Initializer):
    """Dispatch on the parameter name by regex, first match wins, to that
    initializer's own rule (not the base class's name shortcuts)::

        init = Mixed(["bias", ".*"], [Zero(), Uniform(0.1)])
    """

    def __init__(self, patterns, initializers, **kwargs):
        super().__init__(patterns=patterns, initializers=initializers,
                         **kwargs)
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: len(patterns) != len(initializers)")
        self.map = [(re.compile(p), init) for p, init in
                    zip(patterns, initializers)]

    def __call__(self, name, arr, generator=None):
        for pat, init in self.map:
            if pat.search(name or ""):
                with torch.no_grad():
                    init._init_weight(name, arr, _generator(arr, generator))
                return
        raise MXNetError(
            f"Parameter {name!r} matched no Mixed pattern; add '.*' as the "
            "last pattern for a default")

    init_weight = __call__


@register
class InitDesc(str):
    """A parameter name carrying its description (the reference's API
    surface; a plain string here, as in the JAX package)."""


# name-style aliases the reference accepts in create()
_REGISTRY.update(
    zeros=Zero,
    ones=One,
    xavier=Xavier,
    msra=MSRAPrelu,
    uniform=Uniform,
    normal=Normal,
    orthogonal=Orthogonal,
    bilinear=Bilinear,
    constant=Constant,
    lstmbias=LSTMBias,
)


def reference_names(model):
    """``{Gluon name: tensor}`` of every floating parameter and persistent
    buffer of ``model``: the port's name, with a BatchNorm's ``weight`` and
    ``bias`` named ``gamma`` and ``beta``."""
    from .gluon.nn import BatchNorm

    out = {}
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        items = list(mod._parameters.items()) + [
            (n, b) for n, b in mod._buffers.items()
            if n not in mod._non_persistent_buffers_set]
        for name, t in items:
            if t is None or not t.is_floating_point():
                continue
            if isinstance(mod, BatchNorm):
                name = {"weight": "gamma", "bias": "beta"}.get(name, name)
            out[pre + name] = t
    return out


def initialize(model, init=None, generator=None):
    """Fill every floating parameter and persistent buffer of ``model`` in
    place with ``init`` (an :class:`Initializer` or a name for
    :func:`create`; default ``Uniform(0.07)``, Gluon's), under its Gluon
    name (:func:`reference_names`), drawing from ``generator`` or each
    tensor's device stream. Returns ``model``."""
    init = Uniform() if init is None else create(init)
    for name, t in reference_names(model).items():
        init(name, t, generator=generator)
    return model
