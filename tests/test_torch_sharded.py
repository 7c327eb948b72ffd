"""The port's ``parallel.ShardedTrainer`` on one device against the eager
``Trainer`` and against the JAX package's ``ShardedTrainer``.

* f32: one SGD step equals one eager ``Trainer`` step on the mean loss, and
  ``step_n`` over stacked batches equals the same ``step`` calls (the same
  ops on the same device: atol 1e-6).
* ``dtype="bfloat16"`` on ``llama_tiny_test`` (B=2, T=128, Adam at lr 1e-3,
  three steps), with ``remat=True`` (inner AMP: the layers recomputed in
  the backward, their weights cast at use) and ``remat=False``
  (cast-for-compute), weights carried across from the JAX model with
  ``load_reference_params``, the JAX flash attention on the Pallas
  interpreter. Two bf16 computations can round a product differently
  (XLA's CPU bf16 dot against torch's), so the bound on port against JAX
  is set against the port's own distance between bf16 and f32 training:
  losses within ``LOSS_TOL`` = 5e-5 (measured 1.6e-5 and 3.6e-5; the bf16
  runs are 3.9e-4 and 4.6e-4 from the f32 run), and the masters within
  ``PARAM_TOL`` = 8e-3 of how far they moved, in norm (measured 4.7e-3;
  bf16 against f32 3.5e-2). Each bound is checked to be at most a quarter
  of the bf16-against-f32 distance of the same run. Max-abs on the weights
  is no measure here: Adam moves a weight whose gradient is within
  rounding of 0 by about lr either way.
* The dtypes that reach attention are the JAX package's: (q, k, v) in
  (f32, f32, bf16) in layer 0, whose bf16 q and k meet the f32 RoPE tables,
  and f32 in layer 1.
* Recompute on and off give the same losses in f32 (1e-6). In bf16 they
  differ by design, in both packages: under ``remat=True`` the final norm
  and the head run on the f32 masters, under cast-for-compute on bf16
  copies.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.ops import registry as jregistry
from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu_torch import models, resilience
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops.hopper import flash_attention as fa
from mxnet_tpu_torch.parallel import (ShardedTrainer, ShardingRules,
                                      get_mesh, make_mesh, set_mesh)

LOSS_TOL, PARAM_TOL = 5e-5, 8e-3
ADAM = ("adam", {"learning_rate": 1e-3})
F32, BF16 = torch.float32, torch.bfloat16


def _mlp(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(20, 64), torch.nn.ReLU(),
                               torch.nn.Linear(64, 10))


def _copy(a, b):
    b.load_state_dict(a.state_dict())
    return b


def test_sharded_step_matches_eager_trainer():
    """One SPMD-style SGD step equals one eager ``Trainer`` step on the
    mean loss with ``step(1)``."""
    net_a = _mlp(0)
    net_b = _copy(net_a, _mlp(1))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 20).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (16,)))
    lf = tloss.SoftmaxCrossEntropyLoss()
    tr_a = ShardedTrainer(net_a, lf, "sgd", {"learning_rate": 0.1},
                          rules=ShardingRules(default_axis=None))
    loss = tr_a.step(x, y)
    tr_a.sync_to_block()
    tr_b = Trainer(net_b.parameters(), "sgd", {"learning_rate": 0.1})
    ref = lf(net_b(x), y).mean()
    ref.backward()
    tr_b.step(1)
    assert loss.dtype == F32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(ref.detach()), abs=1e-6)
    for pa, pb in zip(net_a.parameters(), net_b.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   atol=1e-6, rtol=0)
        assert pa.grad is None


def test_step_n_matches_sequential_steps():
    net_a = _mlp(2)
    net_b = _copy(net_a, _mlp(3))
    lf = tloss.SoftmaxCrossEntropyLoss()
    opt = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})
    tr_a = ShardedTrainer(net_a, lf, *opt)
    tr_b = ShardedTrainer(net_b, lf, *opt)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 16, 20).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4, 16)))
    fused = tr_a.step_n(x, y)
    seq = torch.stack([tr_b.step(x[i], y[i]) for i in range(4)])
    assert tuple(fused.shape) == (4,)
    np.testing.assert_allclose(fused.numpy(), seq.numpy(), atol=1e-6)
    for pa, pb in zip(net_a.parameters(), net_b.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   atol=1e-6, rtol=0)
    assert tr_a._step_count == tr_b._step_count == 4
    assert tuple(tr_a.step_n(x, y, num_steps=2).shape) == (2,)
    for bad in (0, 5, -1):
        with pytest.raises(MXNetError, match="num_steps"):
            tr_a.step_n(x, y, num_steps=bad)


def test_step_n_holds_the_learning_rate_over_its_window():
    """A scheduler advances between windows, not inside one: the two steps
    of a window both run at the rate of the window's last update count,
    as the JAX package's ``_advance_optimizer`` gives them."""
    from mxnet_tpu_torch.lr_scheduler import FactorScheduler

    net = torch.nn.Linear(3, 1, bias=False)
    torch.nn.init.zeros_(net.weight)
    tr = ShardedTrainer(net, lambda out, y: out.sum(1),
                        "sgd", {"learning_rate": 1.0,
                                "lr_scheduler": FactorScheduler(1, 0.5)})
    x = torch.ones(2, 1, 3)
    tr.step_n(x, torch.zeros(2, 1))
    # d(loss)/dw = 1 per entry; both steps at lr(2) = 0.25
    np.testing.assert_allclose(net.weight.detach().numpy(), -0.5)


def test_constructor_refusals_and_fault_site():
    net = _mlp(5)
    lf = tloss.SoftmaxCrossEntropyLoss()
    for kw, msg in (({"parallel": object()}, "A.4"),
                    ({"zero_bucket_mb": 4}, "ZeRO"),
                    ({"abstract": True}, "abstract"),
                    ({"dtype": "float64"}, "dtype")):
        with pytest.raises(MXNetError, match=msg):
            ShardedTrainer(net, lf, "sgd", **kw)
    with pytest.raises(MXNetError, match="ROADMAP A.4"):
        make_mesh({"dp": 2, "tp": 1}, devices=["cpu"])
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"dp": 1} and mesh.size == 1
    try:
        assert get_mesh(create=True, device="cpu").device.type == "cpu"
        assert get_mesh() is get_mesh(create=True)
    finally:
        set_mesh(None)
    tr = ShardedTrainer(net, lf, "sgd", mesh=mesh)
    x, y = torch.randn(4, 20), torch.randint(0, 10, (4,))
    resilience.install_plan({"rules": [
        {"site": "trainer:sharded_step", "kind": "fatal", "at": [1]}]})
    try:
        tr.step(x, y)
        with pytest.raises(resilience.faults.InjectedFaultError):
            tr.step(x, y)
    finally:
        resilience.clear_plan()
    assert tr._step_count == 1
    with pytest.raises(MXNetError, match="layer_barrier"):
        models.llama.LlamaModel(vocab_size=8, units=8, hidden_size=8,
                                num_layers=1, num_heads=2,
                                layer_barrier=True)


def _jax_train(remat, toks, dtype="bfloat16", steps=3):
    """The JAX ``ShardedTrainer`` on ``llama_tiny_test``: the initial
    weights, per-step losses, final weights and the (q, k, v) dtypes its
    flash attention saw while the step traced."""
    mx.random.seed(0)
    net = jax_get_llama("llama_tiny_test", remat=remat)
    net.initialize()
    init = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    seen, orig = [], jfa._flash_core

    def spy(q, k, v, *args):
        seen.append(tuple(str(a.dtype) for a in (q, k, v)))
        return orig(q, k, v, *args)

    jfa._flash_core = spy
    jfa.use_interpret(True)
    jregistry.set_eager_jit(False)      # trace every op, so spy sees it
    try:
        tr = JaxShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               ADAM[0], dict(ADAM[1]),
                               mesh=jax_make_mesh({"dp": 1}), dtype=dtype)
        losses = [float(tr.step(toks[:, :-1], toks[:, 1:]).asnumpy())
                  for _ in range(steps)]
        assert jfa.last_path() == "pallas"
    finally:
        jregistry.set_eager_jit(True)
        jfa.use_interpret(False)
        jfa._flash_core = orig
    return init, losses, {n: np.asarray(a) for n, a in tr.params.items()}, \
        seen


def _port_train(init, remat, toks, dtype, steps=3):
    model = load_reference_params(
        get_llama("llama_tiny_test", device="cpu", trainable=True,
                  remat=remat), init)
    seen, orig = [], fa._FlashCore.forward

    def spy(ctx, q, k, v, *args):
        seen.append((q.dtype, k.dtype, v.dtype))
        return orig(ctx, q, k, v, *args)

    fa._FlashCore.forward = staticmethod(spy)
    try:
        tr = ShardedTrainer(model, tloss.SoftmaxCrossEntropyLoss(), *ADAM,
                            dtype=dtype)
        x = torch.from_numpy(toks[:, :-1]).long()
        y = torch.from_numpy(toks[:, 1:]).long()
        losses = [float(tr.step(x, y)) for _ in range(steps)]
    finally:
        fa._FlashCore.forward = staticmethod(orig)
    assert fa.last_path() == "torch"
    assert model._amp_dtype is None and not model._in_step
    return losses, {n: p.detach().numpy()
                    for n, p in model.named_parameters()}, seen


def _rel(a, b, init):
    """Norm of a - b over the norm of how far a moved from init."""
    diff = sum(float(((a[n] - b[n]).astype(np.float64) ** 2).sum())
               for n in a)
    moved = sum(float(((a[n] - init[n]).astype(np.float64) ** 2).sum())
                for n in a)
    return (diff / moved) ** 0.5


@pytest.mark.parametrize("remat", [True, False],
                         ids=["remat-inner-amp", "cast-for-compute"])
def test_bf16_sharded_trainer_matches_jax(remat):
    toks = np.random.RandomState(7).randint(
        0, 256, size=(2, 129)).astype(np.int32)
    init, ref_losses, ref_params, ref_seen = _jax_train(remat, toks)
    losses, params, seen = _port_train(init, remat, toks, "bfloat16")
    f32_losses, f32_params, _ = _port_train(init, remat, toks, None)
    # the dtypes the attention saw, forward then (remat) recompute
    assert ref_seen[:2] == [("float32", "float32", "bfloat16"),
                            ("float32", "float32", "float32")]
    assert seen[:2] == [(F32, F32, BF16), (F32, F32, F32)]
    if remat:   # each step: 2 layers, then their recompute, last first
        assert seen[:4] == [(F32, F32, BF16), (F32, F32, F32),
                            (F32, F32, F32), (F32, F32, BF16)]
    assert len(seen) == 3 * (4 if remat else 2)
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    loss_diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
    loss_gap = max(abs(a - b) for a, b in zip(losses, f32_losses))
    rel = _rel(params, ref_params, init)
    rel_gap = _rel(params, f32_params, init)
    assert sorted(params) == sorted(ref_params)
    assert loss_diff <= LOSS_TOL <= loss_gap / 4, (loss_diff, loss_gap)
    assert rel <= PARAM_TOL <= rel_gap / 4, (rel, rel_gap)
    for name, p in params.items():
        assert p.dtype == np.float32, name


def test_recompute_on_and_off_give_the_same_f32_losses():
    toks = np.random.RandomState(8).randint(
        0, 256, size=(2, 129)).astype(np.int32)
    mx.random.seed(0)
    net = jax_get_llama("llama_tiny_test")
    net.initialize()
    init = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    on, p_on, seen_on = _port_train(init, True, toks, None)
    off, p_off, seen_off = _port_train(init, False, toks, None)
    np.testing.assert_allclose(on, off, atol=1e-6, rtol=0)
    for n in p_on:
        np.testing.assert_allclose(p_on[n], p_off[n], atol=1e-6, rtol=0)
    assert len(seen_on) == 2 * len(seen_off)   # the recompute
