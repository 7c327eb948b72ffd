"""ResNet training in the port against the JAX package: train-mode
BatchNorm, ``parallel.ShardedTrainer`` in f32 and bf16 (cast-for-compute),
``step_n``, ``gluon.Trainer``, ``step_flops``.

A bottleneck ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
classes=10, thumbnail=True)`` is built in both packages; the JAX one is
Xavier-initialised and given one train-mode pass (its running statistics
move off their initial values), and its parameters and statistics are
carried over with ``load_reference_params``. Images (4 x 3 x 32 x 32) and
labels come from numpy. The optimizer is ``bench.py``'s SGD (lr 0.1,
momentum 0.9, wd 1e-4) unless a test says otherwise.

Distances are in norm: the norm of (port - JAX) over the norm of how far
the JAX run moved the same tensors (weights, or running statistics).

bf16 (``dtype="bfloat16"``): the JAX side is compiled with XLA's
``xla_allow_excess_precision`` off (``_per_op_rounding``). With it on,
XLA's CPU compiler keeps f32 between the bf16 operations of a fusion and
rounds less often than the JAX package's formula says; with it off the
bf16 forward of the first step is the port's bit for bit (the same loss,
the same batch statistics). The backward is not: the two packages sum the
bf16 convolutions' and products' f32 partial sums in other orders, so a
result now and then rounds to the other neighbour, and BatchNorm's
backward (``inv * (g - mean(g) - xhat * mean(g * xhat))``, terms that
nearly cancel, each rounded to bf16) turns those flips into differences of
bf16's own size. After the first step the two runs hold different weights,
and the bf16 roundings of two different sets of weights are independent
draws. Measured here (lr 1e-3): the first step's update 7.55e-2 of its
norm from the JAX one, where bf16 lies 0.310 from f32; its running
statistics 1.07e-6 of their movement from the JAX ones, where keeping them
in f32 (no state cast) lands 3.10e-2 away; after three steps the losses
2.41e-3 apart (bf16 from f32: 1.26e-2), the statistics 4.42e-3 (2.53e-2)
and the weights 0.172 (0.297). So the test holds the first
step's update, the losses and the statistics to a quarter of bf16's
distance from f32, the first step's loss and statistics to f32 precision,
and the weights after three steps within bf16's own distance. It runs at
lr 1e-3: at bench.py's 0.1 each implementation's own bf16 noise decides
the later steps.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import np as mnp
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.nn import BatchNorm as JaxBatchNorm
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel import functional as tfunctional

LAYERS, CHANNELS = [1, 1, 1, 1], [8, 16, 32, 64, 128]
B, HW, STEPS = 4, 32, 3
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
SGD_BF16 = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}
F32_TOL = 1e-5
_CACHE = {}


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (STEPS, B, 3, HW, HW)).astype(np.float32)
    y = rng.randint(0, 10, (STEPS, B)).astype(np.int32)
    return x, y


def _jax_model(version):
    net_cls = jvision.ResNetV1 if version == 1 else jvision.ResNetV2
    block = jvision.BottleneckV1 if version == 1 else jvision.BottleneckV2
    return net_cls(block, LAYERS, CHANNELS, classes=10, thumbnail=True)


def _port_model(version, init):
    net_cls = tvision.ResNetV1 if version == 1 else tvision.ResNetV2
    block = tvision.BottleneckV1 if version == 1 else tvision.BottleneckV2
    model = net_cls(block, LAYERS, CHANNELS, classes=10, thumbnail=True)
    return tvision.load_reference_params(model, init)


def _init(version=1):
    """The JAX model's parameters and statistics after Xavier and one
    train-mode pass, by JAX name."""
    if version not in _CACHE:
        x, _ = _data()
        mx.random.seed(0)
        net = _jax_model(version)
        net.initialize(init="xavier")
        with autograd.record():
            net(mnp.array(x[0] * 2 + 0.5))
        _CACHE[version] = {k: v.data().asnumpy()
                           for k, v in net.collect_params().items()}
    return _CACHE[version]


def _jax_net(version, init):
    x, _ = _data()
    net = _jax_model(version)
    net.initialize()
    with autograd.predict_mode():
        net(mnp.array(x[0]))
    for k, v in net.collect_params().items():
        v.set_data(mnp.array(init[k]))
    return net


@contextlib.contextmanager
def _per_op_rounding():
    """Compile JAX programs with ``xla_allow_excess_precision`` off."""
    orig = jax.stages.Lowered.compile

    def compile_(self, compiler_options=None, **kw):
        opts = dict(compiler_options or {})
        opts["xla_allow_excess_precision"] = False
        return orig(self, compiler_options=opts, **kw)

    jax.stages.Lowered.compile = compile_
    try:
        yield
    finally:
        jax.stages.Lowered.compile = orig


def _named(model):
    """The port model's state by JAX name, as numpy."""
    names, _ = tvision.resnet._reference_names(model)
    return {names[k]: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _jax_sharded(version, dtype, opt, steps=STEPS):
    """Losses and the state after the first and the last step."""
    init = _init(version)
    x, y = _data()
    net = _jax_net(version, init)
    ctx = _per_op_rounding() if dtype else contextlib.nullcontext()
    with ctx:
        tr = JaxShardedTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                               "sgd", dict(opt),
                               mesh=jax_make_mesh({"dp": 1}), dtype=dtype)
        losses, first = [], None
        for i in range(steps):
            losses.append(float(tr.step(mnp.array(x[i]),
                                        mnp.array(y[i])).asnumpy()))
            state = {n: np.asarray(a) for n, a in tr.params.items()}
            first = state if first is None else first
    return losses, first, state, tr.step_flops


def _port_sharded(version, dtype, opt, steps=STEPS, state_cast=True):
    init = _init(version)
    x, y = _data()
    model = _port_model(version, init)
    tr = ShardedTrainer(model, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(opt), dtype=dtype)
    losses, first = [], None
    ctx = (contextlib.nullcontext() if state_cast else
           _patched(tfunctional, "_state_in",
                    lambda block, dtype: contextlib.nullcontext()))
    with ctx:
        for i in range(steps):
            loss = tr.step(torch.from_numpy(x[i]),
                           torch.from_numpy(y[i]).long())
            assert loss.dtype == torch.float32 and loss.dim() == 0
            losses.append(float(loss))
            state = _named(model)
            first = state if first is None else first
    return losses, first, state, tr


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _rel(a, b, ref, init, stats):
    """Norm of a - b over the norm of ref's movement from init, over the
    running statistics (``stats``) or the trained tensors."""
    keys = [n for n in a if ("running" in n) == stats]
    diff = sum(float(((a[n] - b[n]).astype(np.float64) ** 2).sum())
               for n in keys)
    moved = sum(float(((ref[n] - init[n]).astype(np.float64) ** 2).sum())
                for n in keys)
    return (diff / moved) ** 0.5


def test_f32_sharded_steps_match_jax():
    init = _init()
    j_losses, _, j_state, _ = _jax_sharded(1, None, SGD)
    losses, _, state, tr = _port_sharded(1, None, SGD)
    assert sorted(state) == sorted(j_state) and len(state) == len(init)
    np.testing.assert_allclose(losses, j_losses, atol=F32_TOL, rtol=0)
    assert losses[2] < losses[0]
    assert _rel(state, j_state, j_state, init, stats=False) <= F32_TOL
    assert _rel(state, j_state, j_state, init, stats=True) <= F32_TOL
    for n, a in state.items():
        assert a.dtype == np.float32, n
    assert not any(p.grad is not None for p in tr.block.parameters())


def test_bf16_sharded_steps_match_jax():
    init = _init()
    j_losses, j_first, j_state, _ = _jax_sharded(1, "bfloat16", SGD_BF16)
    losses, first, state, _ = _port_sharded(1, "bfloat16", SGD_BF16)
    f_losses, f_first, f_state, _ = _port_sharded(1, None, SGD_BF16)
    k_losses, k_first, k_state, _ = _port_sharded(1, "bfloat16", SGD_BF16,
                                                  state_cast=False)
    for n, a in state.items():
        assert a.dtype == np.float32, n
    # the first step's forward is the JAX package's (per-op rounding)
    assert abs(losses[0] - j_losses[0]) <= 1e-6
    gap = abs(losses[0] - f_losses[0])
    assert gap > 1e-3
    # its update: within a quarter of bf16's own distance from f32
    w1 = _rel(first, j_first, j_first, init, stats=False)
    w1_gap = _rel(first, f_first, j_first, init, stats=False)
    assert w1 <= w1_gap / 4, (w1, w1_gap)
    # its running statistics: the old ones rounded to bf16, the update in
    # f32, written back at f32. Keeping them in f32 (the alternative
    # without the state cast) lands 1e-2 of their movement away
    s1 = _rel(first, j_first, j_first, init, stats=True)
    s1_kept = _rel(k_first, j_first, j_first, init, stats=True)
    assert s1 <= 1e-5 and s1_kept >= 1e-3, (s1, s1_kept)
    assert s1 <= s1_kept / 100
    # three steps: losses and statistics within a quarter of bf16's
    # distance from f32, the weights within that distance
    loss_diff = max(abs(a - b) for a, b in zip(losses, j_losses))
    loss_gap = max(abs(a - b) for a, b in zip(losses, f_losses))
    assert loss_diff <= loss_gap / 4, (loss_diff, loss_gap)
    s3 = _rel(state, j_state, j_state, init, stats=True)
    s3_gap = _rel(state, f_state, j_state, init, stats=True)
    assert s3 <= s3_gap / 4, (s3, s3_gap)
    w3 = _rel(state, j_state, j_state, init, stats=False)
    w3_gap = _rel(state, f_state, j_state, init, stats=False)
    assert w3 <= w3_gap, (w3, w3_gap)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_step_n_equals_steps(dtype):
    init = _init()
    x, y = _data()
    runs = []
    for window in (False, True):
        model = _port_model(1, init)
        tr = ShardedTrainer(model, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                            dict(SGD), dtype=dtype)
        xs, ys = torch.from_numpy(x), torch.from_numpy(y).long()
        if window:
            losses = tr.step_n(xs, ys)
        else:
            losses = torch.stack([tr.step(xs[i], ys[i])
                                  for i in range(STEPS)])
        runs.append((losses.numpy(), _named(model), tr.step_flops))
    (l_a, s_a, f_a), (l_b, s_b, f_b) = runs
    np.testing.assert_array_equal(l_a, l_b)
    for n in s_a:
        np.testing.assert_array_equal(s_a[n], s_b[n], err_msg=n)
    assert f_a == f_b and f_a > 0


def test_gluon_trainer_steps_match_jax():
    """The eager loop of train_imagenet: MXNet's loss.backward() sums over
    the batch, ``step(batch_size)`` divides by it."""
    init = _init()
    x, y = _data()
    net = _jax_net(1, init)
    jtr = jgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    j_losses = []
    for i in range(STEPS):
        with autograd.record():
            out = jloss(net(mnp.array(x[i])), mnp.array(y[i]))
        out.backward()
        jtr.step(B)
        j_losses.append(float(out.asnumpy().mean()))
    j_state = {k: v.data().asnumpy() for k, v in
               net.collect_params().items()}
    model = _port_model(1, init).train()
    tr = Trainer(model.parameters(), "sgd", dict(SGD))
    lf = tloss.SoftmaxCrossEntropyLoss()
    losses = []
    for i in range(STEPS):
        out = lf(model(torch.from_numpy(x[i])), torch.from_numpy(y[i]))
        out.sum().backward()
        tr.step(B)
        losses.append(float(out.detach().mean()))
    state = _named(model)
    assert len(tr._params) == len([n for n in init
                                   if "running" not in n])
    np.testing.assert_allclose(losses, j_losses, atol=F32_TOL, rtol=0)
    assert _rel(state, j_state, j_state, init, stats=False) <= F32_TOL
    assert _rel(state, j_state, j_state, init, stats=True) <= F32_TOL


def test_v2_fix_gamma_train_step_matches_jax():
    """ResNetV2's stem BatchNorm has ``scale=False, center=False``: gamma
    is fixed at 1, beta is state; one f32 step of each package."""
    init = _init(2)
    assert "features.0.gamma" in init
    j_losses, _, j_state, _ = _jax_sharded(2, None, SGD, steps=1)
    losses, _, state, tr = _port_sharded(2, None, SGD, steps=1)
    stem = tr.block.features[0]
    assert stem.weight is None and not stem.bias.requires_grad
    assert abs(losses[0] - j_losses[0]) <= F32_TOL
    assert _rel(state, j_state, j_state, init, stats=False) <= F32_TOL
    assert _rel(state, j_state, j_state, init, stats=True) <= F32_TOL
    np.testing.assert_array_equal(state["features.0.beta"],
                                  init["features.0.beta"])


def _bn_inputs(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 5, 7, 3) * 2 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    rm = rng.randn(5).astype(np.float32)
    rv = rng.uniform(0.5, 2, 5).astype(np.float32)
    dy = rng.randn(6, 5, 7, 3).astype(np.float32)
    if dtype == "bfloat16":   # values the two packages hold alike
        x, g, b, dy = (torch.from_numpy(a).bfloat16().float().numpy()
                       for a in (x, g, b, dy))
    return x, g, b, rm, rv, dy


def _jax_bn(dtype, train, fix_gamma=False, use_global_stats=False):
    x, g, b, rm, rv, dy = _bn_inputs(dtype)
    ins = [mnp.array(a).astype(dtype or "float32") for a in (x, g, b)]
    stats = [mnp.array(a).astype(dtype or "float32") for a in (rm, rv)]
    for a in ins:
        a.attach_grad()
    with autograd.record(train_mode=train):
        out, mean, var = jops.batch_norm(
            ins[0], ins[1], ins[2], *stats,
            fix_gamma=fix_gamma, use_global_stats=use_global_stats,
            output_mean_var=True)
        head = (out.astype("float32") * mnp.array(dy)).sum()
    head.backward()
    f32 = lambda a: a.astype("float32").asnumpy()   # noqa: E731
    return ([f32(out), f32(mean), f32(var)] + [f32(a.grad) for a in ins])


def _port_bn(dtype, train, fix_gamma=False, use_global_stats=False):
    x, g, b, rm, rv, dy = _bn_inputs(dtype)
    dt = torch.bfloat16 if dtype else torch.float32
    ins = [torch.from_numpy(a).to(dt).requires_grad_() for a in (x, g, b)]
    out, mean, var = tops.batch_norm(
        ins[0], ins[1], ins[2], torch.from_numpy(rm).to(dt),
        torch.from_numpy(rv).to(dt), fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, output_mean_var=True,
        training=train)
    assert out.dtype == dt
    (out.float() * torch.from_numpy(dy)).sum().backward()
    grads = [torch.zeros_like(a) if a.grad is None else a.grad for a in ins]
    return [t.detach().float().numpy() for t in [out, mean, var] + grads]


# bf16 bounds in units of bf16's last place at each output's largest value:
# the forward and the statistics agree to f32 rounding (measured: bit for
# bit); dx within 2 (measured 1.2); dgamma and dbeta within 8: the JAX
# package's bf16 sums over the batch add in bf16 (measured 3.3 and 4.9
# units), where the port's add in f32 and round once: its dbeta lies
# within one unit of the exact sum, checked below
_BF16_ULPS = {"out": 1, "mean": 1e-4, "var": 1e-4, "dx": 2, "dgamma": 8,
              "dbeta": 8}


def _check_bn(got, want, dtype):
    names = ["out", "mean", "var", "dx", "dgamma", "dbeta"]
    for name, a, b in zip(names, got, want):
        scale = max(float(np.abs(b).max()), 1e-30)
        tol = F32_TOL if dtype is None else _BF16_ULPS[name] * 2.0 ** -8
        assert float(np.abs(a - b).max()) <= tol * scale, name
    if dtype is not None:
        dy = _bn_inputs(dtype)[-1].astype(np.float64)
        exact = dy.sum(axis=(0, 2, 3))
        assert np.abs(got[5] - exact).max() <= 2.0 ** -8 * np.abs(
            exact).max()


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_op_matches_jax(dtype, fix_gamma):
    """Train-mode ``ops.nn.batch_norm``: output, batch statistics and the
    gradients of x, gamma and beta, f32 within 1e-5 of each output's
    largest value, bf16 as ``_BF16_ULPS``."""
    got = _port_bn(dtype, True, fix_gamma)
    _check_bn(got, _jax_bn(dtype, True, fix_gamma), dtype)
    if fix_gamma:
        assert not got[4].any()


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_use_global_stats_matches_jax(dtype):
    """``use_global_stats``: the running statistics normalize in train
    mode too, and do not move."""
    _check_bn(_port_bn(dtype, True, use_global_stats=True),
              _jax_bn(dtype, True, use_global_stats=True), dtype)
    # the layers: train mode leaves the statistics where they were
    x, g, b, rm, rv, _ = _bn_inputs(None)
    jl = JaxBatchNorm(use_global_stats=True, in_channels=5)
    jl.initialize()
    for p, a in zip((jl.gamma, jl.beta, jl.running_mean, jl.running_var),
                    (g, b, rm, rv)):
        p.set_data(mnp.array(a))
    with autograd.record():
        jout = jl(mnp.array(x)).asnumpy()
    layer = tnn.BatchNorm(use_global_stats=True, in_channels=5).train()
    with torch.no_grad():
        for t, a in zip((layer.weight, layer.bias, layer.running_mean,
                         layer.running_var), (g, b, rm, rv)):
            t.copy_(torch.from_numpy(a))
    out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(layer.running_mean.numpy(), rm)
    np.testing.assert_array_equal(jl.running_var.data().asnumpy(), rv)


def test_layer_running_update_matches_jax_layer():
    """One train-mode pass of the layer, f32 buffers, with ``axis``:
    JAX's ``m * old + (1 - m) * batch`` with the unbiased variance."""
    x, g, b, rm, rv, _ = _bn_inputs(None)
    for axis in (1, 3):
        c = x.shape[axis]
        jl = JaxBatchNorm(axis=axis, momentum=0.8, in_channels=c)
        jl.initialize()
        layer = tnn.BatchNorm(axis=axis, momentum=0.8, in_channels=c)
        layer.reset_parameters()
        with autograd.record():
            jout = jl(mnp.array(x)).asnumpy()
        out = layer.train()(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5,
                                   rtol=0)
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(
                getattr(layer, name).numpy(),
                getattr(jl, name).data().asnumpy(), atol=1e-6, rtol=1e-6,
                err_msg=f"{name} axis={axis}")


def test_step_flops_counts_the_products_and_tracks_jax():
    """``step_flops`` is counted once per signature and cached; it equals
    the products counted by hand. Against the JAX trainer's XLA figure, which
    also counts elementwise work (BatchNorm, ReLU, the update): 0.759 of it
    in f32 on this model (measured: 39,745,536 against 52,339,268)."""
    _, _, _, j_flops = _jax_sharded(1, None, SGD, steps=1)
    init = _init()
    x, y = _data()
    model = _port_model(1, init)
    tr = ShardedTrainer(model, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(SGD))
    assert tr.step_flops is None and tr.step_cost_analysis == {}
    tr.step(torch.from_numpy(x[0]), torch.from_numpy(y[0]).long())
    flops = tr.step_flops
    assert tr.step_cost_analysis == {"flops": flops}
    assert list(tr._flops.values()) == [flops]
    tr.step(torch.from_numpy(x[1]), torch.from_numpy(y[1]).long())
    assert len(tr._flops) == 1 and tr.step_flops == flops
    # the stride-2 stages: spatial sizes from the features' own shapes
    sizes = {}

    def hook(mod, inp, out):
        sizes[mod] = (inp[0].shape, out.shape)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, tnn.Conv2D)]
    with torch.no_grad():
        model(torch.from_numpy(x[0]))
    for h in handles:
        h.remove()
    by_hand = 0
    for mod, (ishape, oshape) in sizes.items():
        o, i, kh, kw = mod.weight.shape
        macs = oshape[0] * o * i * kh * kw * oshape[2] * oshape[3]
        grads = 1 if mod is model.features[0] else 2
        by_hand += 2 * macs * (1 + grads)
    w = model.output.weight
    by_hand += 2 * B * w.shape[0] * w.shape[1] * 3
    assert flops == by_hand
    assert 0.70 <= flops / j_flops <= 0.80, (flops, j_flops)


@pytest.mark.parametrize("case", [
    ((2, 3, 32, 32), (8, 3, 7, 7), 2, 3), ((2, 8, 9, 9), (4, 8, 3, 3), 1, 1),
    ((2, 8, 9, 9), (6, 8, 3, 3), 2, 1), ((2, 8, 8, 8), (16, 8, 1, 1), 2, 0),
    ((2, 8, 8, 8), (16, 8, 1, 1), 1, 0)],
    ids=["7x7_s2", "3x3", "3x3_s2", "1x1_s2", "1x1"])
def test_convolution_gradients_match_float64(case):
    """The f32 convolution's forward and both gradients (its weight
    gradient a matrix product over the unfolded input) within 1e-6 of
    float64, as a share of each output's largest value, and against the
    JAX package's convolution gradients to 1e-5."""
    xs, ws, stride, pad = case
    rng = np.random.RandomState(5)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) / np.sqrt(ws[1])).astype(np.float32)
    x64 = torch.from_numpy(x).double().requires_grad_()
    w64 = torch.from_numpy(w).double().requires_grad_()
    y64 = torch.nn.functional.conv2d(x64, w64, None, stride, pad)
    gy = rng.randn(*y64.shape).astype(np.float32)
    y64.backward(torch.from_numpy(gy).double())
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = tops.convolution(xt, wt, None, stride, pad)
    yt.backward(torch.from_numpy(gy))
    for got, want in ((yt, y64), (xt.grad, x64.grad), (wt.grad, w64.grad)):
        want = want.detach().numpy()
        assert np.abs(got.detach().numpy() - want).max() <= 1e-6 * np.abs(
            want).max()
    jx, jw = mnp.array(x), mnp.array(w)
    jx.attach_grad()
    jw.attach_grad()
    with autograd.record():
        jy = jops.convolution(jx, jw, None, kernel=ws[2:], stride=stride,
                              pad=pad, num_filter=ws[0], no_bias=True)
        head = (jy * mnp.array(gy)).sum()
    head.backward()
    for got, want in ((xt.grad, jx.grad), (wt.grad, jw.grad)):
        want = want.asnumpy()
        assert np.abs(got.numpy() - want).max() <= F32_TOL * np.abs(
            want).max()
