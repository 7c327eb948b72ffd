"""The port's ``initializer`` against the JAX package's.

Deterministic rules (``Zero``, ``One``, ``Constant``, ``Bilinear``,
``LSTMBias``, the name dispatch, ``Mixed``) must give the JAX package's
values exactly. Random rules draw from a ``torch.Generator``, not
threefry, so they are held on what defines them: bounds, fans, moments
(over 2**16 draws: the mean within 5 standard errors, the standard
deviation within 2%) and, for ``Orthogonal``, orthogonality to 1e-5.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import initializer as jinit
from mxnet_tpu import np as mnp
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision


def _jax(init, name, shape):
    arr = mnp.array(np.zeros(shape, np.float32))
    init(name, arr)
    return arr.asnumpy()


def _port(init, name, shape, seed=0):
    t = torch.zeros(shape)
    init(name, t, generator=torch.Generator().manual_seed(seed))
    return t.numpy()


@pytest.mark.parametrize("name,args", [
    ("Zero", {}), ("One", {}), ("Constant", {"value": 0.5}),
    ("Bilinear", {}), ("LSTMBias", {"forget_bias": 2.0})])
@pytest.mark.parametrize("shape", [(8, 1, 4, 4), (12, 3, 3, 5)])
def test_deterministic_rules_exact(name, args, shape):
    want = _jax(getattr(jinit, name)(**args), "conv0_weight", shape)
    got = _port(getattr(tinit, name)(**args), "conv0_weight", shape)
    np.testing.assert_array_equal(got, want)


def test_constant_broadcasts_an_array():
    v = np.arange(4, dtype=np.float32)
    want = _jax(jinit.Constant(mnp.array(v)), "w", (3, 4))
    np.testing.assert_array_equal(
        _port(tinit.Constant(torch.from_numpy(v)), "w", (3, 4)), want)
    np.testing.assert_array_equal(_port(tinit.Constant(v), "w", (3, 4)),
                                  want)


@pytest.mark.parametrize("name", [
    "bn_gamma", "bn_beta", "dense0_bias", "bn_running_mean",
    "bn_running_var", "bn_moving_mean", "bn_moving_var"])
@pytest.mark.parametrize("init", ["xavier", "uniform", "normal",
                                  "orthogonal", "msra"])
def test_name_dispatch_exact(name, init):
    want = _jax(jinit.create(init), name, (6,))
    np.testing.assert_array_equal(_port(tinit.create(init), name, (6,)),
                                  want)


def test_initialize_maps_batchnorm_weight_to_gamma():
    """``initialize`` on a port ResNet under Xavier: every BatchNorm gamma
    1, beta 0, running mean 0, variance 1, and the dense bias 0, as the JAX
    package's ``initialize(init="xavier")`` gives them; the convolution
    and dense weights within Xavier's bounds."""
    layers, channels = [1, 1, 1, 1], [8, 16, 32, 64, 128]
    net = jvision.ResNetV1(jvision.BottleneckV1, layers, channels,
                           classes=10, thumbnail=True)
    net.initialize(init="xavier")
    net(mnp.array(np.zeros((1, 3, 16, 16), np.float32)))
    want = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    model = tvision.ResNetV1(tvision.BottleneckV1, layers, channels,
                             classes=10, thumbnail=True)
    tinit.initialize(model, "xavier",
                     generator=torch.Generator().manual_seed(1))
    got = {k: t.detach().numpy() for k, t in
           tinit.reference_names(model).items()}
    assert sorted(got) == sorted(want)
    for name, arr in got.items():
        if name.endswith("weight"):
            fan_in, fan_out = tinit._fans(arr.shape)
            bound = math.sqrt(3.0 / ((fan_in + fan_out) / 2))
            assert np.abs(arr).max() <= bound
            assert np.abs(arr).max() > 0.5 * bound, name
            assert np.abs(want[name]).max() <= bound * (1 + 1e-6)
        else:
            np.testing.assert_array_equal(arr, want[name], err_msg=name)


def test_default_is_uniform_007_and_seeded():
    model = tvision.ResNetV1(tvision.BottleneckV1, [1, 1, 1, 1],
                             [8, 16, 32, 64, 128], classes=10,
                             thumbnail=True)
    from mxnet_tpu_torch import random as trandom

    try:
        trandom.seed(3)
        tinit.initialize(model)
        w = model.output.weight.detach().clone()
        assert 0.06 < float(w.abs().max()) <= 0.07
        trandom.seed(3)
        tinit.initialize(model)
        assert torch.equal(w, model.output.weight.detach())
        trandom.seed(4)
        tinit.initialize(model)
        assert not torch.equal(w, model.output.weight.detach())
    finally:
        trandom.seed(0)
    assert float(model.features[1][0].body[1].weight.detach().min()) == 1.0


def _moments(arr, mean, std):
    n = arr.size
    assert abs(arr.mean() - mean) <= 5 * std / math.sqrt(n)
    assert abs(arr.std() / std - 1) <= 0.02


SHAPE = (256, 64, 2, 2)  # fan_in 256, fan_out 1024, 2**16 draws


@pytest.mark.parametrize("kind", ["uniform", "normal", "xavier_avg",
                                  "xavier_in", "xavier_out_gauss", "msra"])
def test_random_rules_bounds_and_moments(kind):
    fan_in, fan_out = 64 * 4, 256 * 4
    if kind == "uniform":
        init, std, bound = tinit.Uniform(0.3), 0.3 / math.sqrt(3), 0.3
    elif kind == "normal":
        init, std, bound = tinit.Normal(0.2), 0.2, None
    elif kind.startswith("xavier"):
        factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
                  "out": fan_out}[kind.split("_")[1]]
        scale = math.sqrt(3 / factor)
        gauss = kind.endswith("gauss")
        init = tinit.Xavier("gaussian" if gauss else "uniform",
                            kind.split("_")[1], 3)
        std, bound = (scale, None) if gauss else (scale / math.sqrt(3),
                                                  scale)
    else:
        init = tinit.MSRAPrelu("in", slope=0.25)
        std, bound = math.sqrt(2.0 / (1 + 0.25 ** 2) / fan_in), None
    arr = _port(init, "conv_weight", SHAPE)
    _moments(arr.astype(np.float64), 0.0, std)
    if bound is not None:
        assert np.abs(arr).max() <= bound and np.abs(arr).max() > 0.99 * bound
    # the same generator seed draws the same values; another seed others
    np.testing.assert_array_equal(arr, _port(init, "conv_weight", SHAPE))
    assert not np.array_equal(arr, _port(init, "conv_weight", SHAPE, 1))


@pytest.mark.parametrize("shape", [(16, 48), (48, 16), (8, 4, 3, 3)])
def test_orthogonal(shape):
    got = _port(tinit.Orthogonal(scale=1.5), "w", shape)
    want = _jax(jinit.Orthogonal(scale=1.5), "w", shape)
    for arr in (got, want):
        m = arr.reshape(shape[0], -1).astype(np.float64)
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(len(gram)),
                                   atol=1e-5 * 1.5 ** 2)


def test_mixed_dispatch_and_registry():
    patterns, shape = ["bias", ".*"], (4, 3)
    j = jinit.Mixed(patterns, [jinit.Constant(2.0), jinit.One()])
    t = tinit.Mixed(patterns, [tinit.Constant(2.0), tinit.One()])
    for name in ("fc_bias", "fc_weight", "bn_gamma"):
        np.testing.assert_array_equal(_port(t, name, shape),
                                      _jax(j, name, shape))
    with pytest.raises(MXNetError, match="matched no Mixed pattern"):
        tinit.Mixed(["bias"], [tinit.Zero()])("w", torch.zeros(2))
    with pytest.raises(MXNetError, match="len"):
        tinit.Mixed(["a"], [])
    with pytest.raises(MXNetError, match="unknown initializer"):
        tinit.create("nope")
    for alias in ("zeros", "ones", "xavier", "msra", "uniform", "normal",
                  "orthogonal", "bilinear", "constant", "lstmbias"):
        assert type(tinit.create(alias)).__name__ == type(
            jinit.create(alias)).__name__
    for init in ("xavier", "msra", "uniform", "normal"):
        assert tinit.create(init).dumps() == jinit.create(init).dumps()
    with pytest.raises(MXNetError, match="factor_type"):
        _port(tinit.Xavier(factor_type="x"), "w", (2, 2))
    with pytest.raises(MXNetError, match="rnd_type"):
        _port(tinit.Xavier(rnd_type="x"), "w", (2, 2))

    @tinit.register
    class Twos(tinit.Initializer):
        def _init_weight(self, name, arr, gen):
            arr.fill_(2)

    assert _port(tinit.create("twos"), "w", (2,)).tolist() == [2, 2]
