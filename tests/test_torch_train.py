"""The port's training slice against the JAX package's.

Weights come from the JAX model (``mx.random.seed(0)``, default init) and
are carried across with ``load_reference_params``; tokens, gradients and
weights of the small cases come from numpy seeds. The JAX side runs its
flash attention through the Pallas interpreter (``use_interpret(True)``,
restored in ``finally``), so its cache-free forward and backward take the
TPU kernels; the port's CPU tensors take the kernels' plain versions.

Tolerances, each against the JAX package on the same inputs:

* cache-free logits: atol 1e-4, the bound of the serving comparison in
  ``test_torch_llama.py`` (the same f32 function, sums in another order;
  measured ~1e-6);
* losses: atol 1e-5 / rtol 1e-6;
* update rules: atol 1e-6 over five steps (the same ops in the same order;
  measured ~1e-8);
* learning-rate schedules: equal;
* three ``Trainer`` steps on ``llama_tiny_test``: losses and parameters
  within atol 1e-6 for SGD with momentum; atol 1e-4 for Adam at lr 1e-3,
  whose first steps move each weight by about lr times the sign of its
  gradient, so a gradient within rounding of 0 may step the other way.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops.hopper import flash_attention as fa

_NETS = {}


def _jax_net(config):
    """A fresh JAX model with seed-0 weights, and those weights as numpy."""
    mx.random.seed(0)
    net = jax_get_llama(config)
    net.initialize()
    params = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    return net, params


def _port_net(params, config, trainable=False):
    return load_reference_params(
        get_llama(config, device="cpu", trainable=trainable), params)


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("config,t", [("llama_tiny_test", 96),
                                      ("llama_serve_12l_test", 64)])
def test_cache_free_forward_matches_jax(config, t):
    """``LlamaModel.forward`` without a cache: the JAX model's logits, its
    attention on the Pallas kernels (interpret), the port's on
    ``_FlashCore``."""
    net, params = _jax_net(config)
    port = _port_net(params, config)
    toks = _tokens(2, t, params["embed.weight"].shape[0])
    jfa.use_interpret(True)
    try:
        ref = net(mx.np.array(toks)).asnumpy()
        assert jfa.last_path() == "pallas"
    finally:
        jfa.use_interpret(False)
    with torch.no_grad():
        out = port(torch.from_numpy(toks))
    assert fa.last_path() == "torch"
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["sparse", "from_logits", "dense", "weight",
                                  "axis1"])
def test_softmax_cross_entropy_matches_jax(kind):
    rng = np.random.RandomState(4)
    pred = (rng.randn(3, 5, 7) * 3).astype(np.float32)
    label = rng.randint(0, 7, size=(3, 5)).astype(np.int32)
    kw, lab = {}, label
    if kind == "from_logits":
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
        kw = {"from_logits": True}
    elif kind == "dense":
        lab = np.eye(7, dtype=np.float32)[label]
        kw = {"sparse_label": False}
    elif kind == "weight":
        kw = {"weight": 0.5}
    elif kind == "axis1":
        pred = np.ascontiguousarray(pred.transpose(0, 2, 1))
        kw = {"axis": 1}
    ref = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        mx.np.array(pred), mx.np.array(lab)).asnumpy()
    out = tloss.SoftmaxCELoss(**kw)(torch.from_numpy(pred),
                                    torch.from_numpy(lab))
    assert tuple(out.shape) == ref.shape == (3,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-6)


def test_l2_loss_and_sample_weight_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(4, 6).astype(np.float32)
    label = rng.randn(4, 6).astype(np.float32)
    sw = rng.rand(4, 1).astype(np.float32)
    ref = mx.gluon.loss.L2Loss()(mx.np.array(pred), mx.np.array(label),
                                 mx.np.array(sw)).asnumpy()
    out = tloss.L2Loss()(torch.from_numpy(pred), torch.from_numpy(label),
                         torch.from_numpy(sw))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    batch1 = tloss.L2Loss(batch_axis=1)(torch.from_numpy(pred),
                                        torch.from_numpy(label))
    assert tuple(batch1.shape) == (6,)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5, "rescale_grad": 0.25}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 1.0,
              "rescale_grad": 0.5}),
    ("adam", {"learning_rate": 0.01, "correct_bias": False}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.1, "rescale_grad": 2.0}),
], ids=["sgd", "sgd-momentum-wd-clip", "adam-wd-clip", "adam-nobias",
        "adamw"])
def test_update_rules_match_jax(name, kw):
    """``Optimizer.update`` over five steps on two weights: the port's in
    place rule against the JAX package's ``_update_raw``."""
    rng = np.random.RandomState(6)
    weights = [rng.randn(5, 3).astype(np.float32),
               rng.randn(4).astype(np.float32)]
    grads = [[(rng.randn(*w.shape) * 2).astype(np.float32) for w in weights]
             for _ in range(5)]
    jopt = mx.optimizer.create(name, **kw)
    topt_ = topt.create(name, **kw)
    jw = [mx.nd.array(w) for w in weights]
    tw = [torch.from_numpy(w.copy()) for w in weights]
    js = [jopt.create_state(i, w) for i, w in enumerate(jw)]
    ts = [topt_.create_state(i, w) for i, w in enumerate(tw)]
    for step in grads:
        for i, g in enumerate(step):
            jopt.update(i, jw[i], mx.nd.array(g), js[i])
            topt_.update(i, tw[i], torch.from_numpy(g), ts[i])
    for j, t in zip(jw, tw):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), atol=1e-6,
                                   rtol=0)
    assert topt_._index_update_count == {0: 5, 1: 5}


def test_optimizer_registry_and_learning_rate():
    with pytest.raises(MXNetError, match="unknown optimizer"):
        topt.create("no_such_optimizer")
    opt = topt.create("SGD", learning_rate=0.5)
    assert isinstance(opt, topt.SGD) and topt.create(opt) is opt
    assert opt.learning_rate == 0.5
    opt.set_learning_rate(0.25)
    assert opt.learning_rate == 0.25
    sched = tlrs.FactorScheduler(step=2, factor=0.5)
    opt = topt.create("adam", learning_rate=0.1, lr_scheduler=sched)
    assert sched.base_lr == 0.1
    w, g = torch.ones(3), torch.ones(3)
    st = opt.create_state(0, w)
    for _ in range(3):
        opt.update(0, w, g, st)
    assert opt.learning_rate == pytest.approx(0.05)  # 3 updates: one halving


@pytest.mark.parametrize("name,args,kw", [
    ("FactorScheduler", (3,), {"factor": 0.5, "stop_factor_lr": 1e-3,
                               "base_lr": 0.1, "warmup_steps": 2}),
    ("MultiFactorScheduler", ([2, 5],), {"factor": 0.1, "base_lr": 1.0}),
    ("PolyScheduler", (10,), {"base_lr": 0.2, "pwr": 2, "final_lr": 0.01,
                              "warmup_steps": 3,
                              "warmup_mode": "constant",
                              "warmup_begin_lr": 0.05}),
    ("CosineScheduler", (8,), {"base_lr": 0.3, "final_lr": 0.02,
                               "warmup_steps": 2}),
])
def test_lr_scheduler_values_match_jax(name, args, kw):
    ref = getattr(jlrs, name)(*args, **kw)
    ours = getattr(tlrs, name)(*args, **kw)
    assert [ours(n) for n in range(14)] == [ref(n) for n in range(14)]


def _train_jax(net, opt, opt_kw, toks, steps):
    from mxnet_tpu import autograd, gluon

    x, y = mx.np.array(toks[:, :-1]), mx.np.array(toks[:, 1:])
    tr = gluon.Trainer(net.collect_params(), opt, dict(opt_kw))
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    jfa.use_interpret(True)
    try:
        for _ in range(steps):
            with autograd.record():
                loss = lf(net(x), y)
            loss.backward()
            tr.step(toks.shape[0])
            assert jfa.last_path() == "pallas"
            losses.append(loss.asnumpy())
    finally:
        jfa.use_interpret(False)
    return losses, {k: v.data().asnumpy()
                    for k, v in net.collect_params().items()}


def _train_port(model, opt, opt_kw, toks, steps):
    x = torch.from_numpy(toks[:, :-1])
    y = torch.from_numpy(toks[:, 1:])
    tr = Trainer(model.parameters(), opt, dict(opt_kw))
    lf = tloss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        loss = lf(model(x), y)
        loss.sum().backward()       # MXNet's loss.backward()
        tr.step(toks.shape[0])
        losses.append(loss.detach().numpy())
    return losses, {k: p.detach().numpy()
                    for k, p in model.named_parameters()}


@pytest.mark.parametrize("opt,opt_kw,atol", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 1e-6),
    ("adam", {"learning_rate": 1e-3}, 1e-4),
], ids=["sgd-momentum", "adam"])
def test_three_trainer_steps_match_jax_trainer(opt, opt_kw, atol):
    """Three ``Trainer`` steps on ``llama_tiny_test`` (B=2, T=128) against
    the JAX ``gluon.Trainer`` loop: per-step per-sample losses and every
    parameter after step 3."""
    net, params = _jax_net("llama_tiny_test")
    model = _port_net(params, "llama_tiny_test", trainable=True)
    toks = _tokens(2, 129, 256, seed=7)
    ref_losses, ref_params = _train_jax(net, opt, opt_kw, toks, 3)
    losses, ours = _train_port(model, opt, opt_kw, toks, 3)
    for a, b in zip(losses, ref_losses):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    assert losses[2].mean() < losses[0].mean()
    assert sorted(ours) == sorted(ref_params)
    for name, p in ours.items():
        np.testing.assert_allclose(p, ref_params[name], atol=atol, rtol=0,
                                   err_msg=name)


def test_trainer_semantics(tmp_path):
    """Gradients are consumed by the step (MXNet's grad_req="write"), a
    missing gradient raises unless ignored, the global-norm clip, the
    learning-rate accessors and the states round trip."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    frozen = torch.nn.Parameter(torch.ones(2), requires_grad=False)
    params = list(lin.parameters()) + [frozen]
    tr = Trainer(params, "sgd", {"learning_rate": 0.1, "momentum": 0.5},
                 clip_global_norm=0.01)
    assert len(tr._params) == 2 and tr.learning_rate == 0.1
    x = torch.randn(5, 4)
    before = lin.weight.detach().clone()
    lin(x).sum().backward()
    raw = torch.cat([p.grad.flatten() for p in lin.parameters()])
    assert float(raw.norm()) > 0.01
    tr.step(5)
    assert all(p.grad is None for p in lin.parameters())
    moved = (before - lin.weight.detach()).norm()
    # clipped to norm 0.01, then scaled by 1 / 5, at lr 0.1
    assert float(moved) <= 0.1 * 0.01 / 5 + 1e-9
    with pytest.raises(MXNetError, match="no gradient"):
        tr.step(5)
    lin.weight.grad = torch.ones_like(lin.weight)
    tr.step(1, ignore_stale_grad=True)  # the bias has none: skipped
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05 and tr.optimizer.lr == 0.05
    tr.save_states(tmp_path / "states.bin")
    mom = tr._states[0][0].clone()
    tr._states[0][0].zero_()
    tr._step_count = 0
    tr.load_states(tmp_path / "states.bin")
    assert torch.equal(tr._states[0][0], mom) and tr._step_count == 2
    with pytest.raises(MXNetError, match="clip_global_norm"):
        Trainer(params, "sgd", clip_global_norm=0)
    with pytest.raises(MXNetError, match="tensors"):
        Trainer([1.0], "sgd")


def test_trainer_save_load_states_file(tmp_path):
    w = torch.nn.Parameter(torch.ones(3))
    tr = Trainer({"w": w}, "adam", {"learning_rate": 0.1})
    (w * 2).sum().backward()
    tr.step(1)
    path = tmp_path / "states.bin"
    tr.save_states(path)
    tr2 = Trainer({"w": torch.nn.Parameter(torch.ones(3))}, "adam")
    tr2.load_states(path)
    for a, b in zip(tr._states[0], tr2._states[0]):
        assert torch.equal(a, b)
    assert tr2._step_count == 1
