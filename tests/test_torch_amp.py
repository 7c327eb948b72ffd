"""The port's ``amp`` module and ``gluon.Trainer``'s loss-scaler path
against the JAX package's.

Scripted overflow sequences run through both ``LossScaler``s and through
both ``Trainer``s on a Dense model with an L2 loss (weights from the JAX
model, inputs from numpy seeds, a NaN or inf written into a gradient at the
scripted steps):

* the scalers' ``loss_scale``, ``overflows`` and ``skipped_steps`` are
  equal after every update (plain float arithmetic on both sides);
* a skipped step leaves the port's weights bit-identical;
* after every step the port's weights match the JAX ``Trainer``'s to atol
  1e-6 (the same f32 update, sums in another order; measured ~1e-8).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu_torch import amp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.profiler import core as tprof
from mxnet_tpu_torch.resilience import counters as tcounters
from mxnet_tpu_torch.resilience import guardrails

# (constructor kwargs, overflow per update)
SCALER_CASES = [
    ({"init_scale": 8.0, "scale_window": 2},
     [False, False, True, False, False, False, True, True, False]),
    ({"init_scale": 2.0 ** 16, "scale_factor": 4.0, "scale_window": 1},
     [False] * 6 + [True] * 3),
    ({"init_scale": 4.0, "scale_window": 1, "min_scale": 2.0,
      "max_scale": 16.0}, [True] * 4 + [False] * 6 + [True]),
    ({"init_scale": 1e9, "scale_window": 3},          # clamped to 2**24
     [False] * 4 + [True] + [False] * 3),
]


def _trace(scaler, overflows):
    out = []
    for o in overflows:
        skip = scaler.update(o)
        out.append((skip, scaler.loss_scale, scaler.overflows,
                    scaler.skipped_steps))
    return out


@pytest.mark.parametrize("kw,overflows", SCALER_CASES,
                         ids=["window2", "factor4", "clamps", "init-clamp"])
def test_loss_scaler_sequences_match_jax(kw, overflows):
    ref = jamp.LossScaler(**kw)
    ours = amp.LossScaler(**kw)
    assert ours.loss_scale == ref.loss_scale
    assert _trace(ours, overflows) == _trace(ref, overflows)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -3.0, 0.0])
def test_loss_scaler_repairs_an_assigned_scale_as_jax(bad):
    ref = jamp.LossScaler(init_scale=64.0, scale_window=2, min_scale=2.0)
    ours = amp.LossScaler(init_scale=64.0, scale_window=2, min_scale=2.0)
    ref.loss_scale = ours.loss_scale = bad
    seq = [False, True, False, False]
    assert _trace(ours, seq) == _trace(ref, seq)


@pytest.mark.parametrize("kw", [
    {"init_scale": float("nan")}, {"init_scale": 0.0},
    {"init_scale": -1.0}, {"scale_factor": 1.0},
    {"scale_factor": float("inf")}, {"min_scale": 0.0},
    {"min_scale": 8.0, "max_scale": 4.0}, {"max_scale": float("inf")},
])
def test_loss_scaler_rejects_what_jax_rejects(kw):
    with pytest.raises(JaxMXNetError):
        jamp.LossScaler(**kw)
    with pytest.raises(MXNetError):
        amp.LossScaler(**kw)


def test_loss_scaler_env_clamps(monkeypatch):
    monkeypatch.setenv("MXNET_LOSS_SCALE_MIN", "4.0")
    monkeypatch.setenv("MXNET_LOSS_SCALE_MAX", "16.0")
    ref, ours = jamp.LossScaler(init_scale=1024.0), amp.LossScaler(
        init_scale=1024.0)
    assert ours.loss_scale == ref.loss_scale == 16.0
    seq = [True] * 5
    assert _trace(ours, seq) == _trace(ref, seq)
    assert ours.loss_scale == 4.0


def test_amp_policy_and_block_conversion():
    assert not amp.is_enabled() and amp.target_dtype() is None
    try:
        assert amp.init("float16") == "float16" and amp.is_enabled()
        assert amp.target_dtype() == "float16"
    finally:
        amp.disable()
    assert not amp.is_enabled() and amp.target_dtype() is None
    with pytest.raises(MXNetError, match="bfloat16/float16"):
        amp.init("int8")
    assert amp.list_fp16_ops() == jamp.list_fp16_ops()
    assert amp.list_fp32_ops() == jamp.list_fp32_ops()

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x, ids):
            seen.append((x.dtype, ids.dtype))
            return x * 2, ids

    wrapped = amp.convert_hybrid_block(Probe())
    out, ids = wrapped(torch.ones(2), torch.arange(2))
    assert seen == [(torch.bfloat16, torch.int64)]
    assert out.dtype == torch.float32 and ids.dtype == torch.int64
    lin = torch.nn.Linear(3, 2)
    assert amp.convert_model(lin, "float16", cast_params=True) is lin
    assert lin.weight.dtype == torch.float16
    with pytest.raises(MXNetError, match="target_dtype"):
        amp.convert_hybrid_block(lin, "float64")
    s = amp.LossScaler(init_scale=4.0)
    assert amp.scale_loss([torch.tensor(1.0), torch.tensor(2.0)], s) == [
        torch.tensor(4.0), torch.tensor(8.0)]
    assert s.has_overflow([torch.ones(2), torch.tensor([1.0, float("inf")])])
    assert not s.has_overflow([torch.ones(2), None])
    assert [float(g) for g in s.unscale([torch.tensor(8.0)])] == [2.0]


def test_guardrails_match_jax():
    from mxnet_tpu.resilience import guardrails as jgr

    rng = np.random.RandomState(3)
    arrays = [rng.randn(4, 3).astype(np.float32) * 5,
              rng.randn(7).astype(np.float32)]
    ours = [torch.from_numpy(a.copy()) for a in arrays]
    _, norm = guardrails.clip_by_global_norm(ours, 1.5)
    ref, ref_norm = jgr.clip_by_global_norm(
        [mx.np.array(a) for a in arrays], 1.5, in_place=False)
    assert norm == pytest.approx(ref_norm, rel=1e-6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    bad = [torch.ones(2), torch.tensor([float("nan")])]
    assert guardrails.clip_by_global_norm(bad, 1.0)[0][0].tolist() == [1, 1]
    assert guardrails.all_finite([torch.ones(3), None])
    assert not guardrails.all_finite(bad)


def _jax_dense(seed):
    from mxnet_tpu import gluon

    mx.random.seed(seed)
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize()
    net(mx.np.ones((1, 3)))
    return net


def _poison_jax(tr, kind):
    g = tr._params[0].grad()
    g._set_data_internal(g._data * float(kind))


# (step, kind) pairs written into the first gradient before the step
SCRIPT = {1: "nan", 4: "inf", 5: "nan"}


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
def test_trainer_scaler_steps_match_jax_trainer(clip):
    """Eight ``Trainer`` steps (SGD with momentum, a ``LossScaler`` with a
    window of 2) on a Dense + L2 model with a NaN or inf gradient at steps
    1, 4 and 5: the port's weights equal the JAX ``Trainer``'s after every
    step, a skipped step leaves them bit-identical, and the scalers agree
    step for step."""
    from mxnet_tpu import autograd, gluon

    net = _jax_dense(11)
    names = list(net.collect_params())
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            net.collect_params()[names[0]].data().asnumpy()))
        lin.bias.copy_(torch.from_numpy(
            net.collect_params()[names[1]].data().asnumpy()))
    kw = {"loss_scaler": None, "clip_global_norm": clip}
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    jtr = gluon.Trainer(net.collect_params(), *opt,
                        **dict(kw, loss_scaler=jamp.LossScaler(
                            init_scale=8.0, scale_window=2)))
    ttr = Trainer([lin.weight, lin.bias], *opt,
                  **dict(kw, loss_scaler=amp.LossScaler(init_scale=8.0,
                                                        scale_window=2)))
    jlf, tlf = gluon.loss.L2Loss(), tloss.L2Loss()
    rng = np.random.RandomState(2)
    tcounters.reset()
    for step in range(8):
        x = rng.randn(4, 3).astype(np.float32)
        y = rng.randn(4, 2).astype(np.float32)
        with autograd.record():
            loss = jtr.scale_loss(jlf(net(mx.np.array(x)), mx.np.array(y)))
        loss.backward()
        tl = ttr.scale_loss(tlf(lin(torch.from_numpy(x)),
                                torch.from_numpy(y)))
        tl.sum().backward()
        if step in SCRIPT:
            _poison_jax(jtr, SCRIPT[step])
            with torch.no_grad():
                lin.weight.grad.mul_(float(SCRIPT[step]))
        before = [p.detach().clone() for p in (lin.weight, lin.bias)]
        jtr.step(4)
        ttr.step(4)
        after = [lin.weight.detach(), lin.bias.detach()]
        if step in SCRIPT:
            for a, b in zip(after, before):
                assert torch.equal(a, b)
            assert lin.weight.grad is None and lin.bias.grad is None
        ref = [net.collect_params()[n].data().asnumpy() for n in names]
        for a, r in zip(after, ref):
            np.testing.assert_allclose(a.numpy(), r, atol=1e-6, rtol=0)
        js, ts = jtr.loss_scaler, ttr.loss_scaler
        assert (ts.loss_scale, ts.overflows, ts.skipped_steps) == (
            js.loss_scale, js.overflows, js.skipped_steps)
    assert ttr.loss_scaler.skipped_steps == len(SCRIPT)
    assert tcounters.get("resilience.loss_scale_overflows") == len(SCRIPT)


def test_trainer_scaler_records_overflow_instant_and_detaches():
    lin = torch.nn.Linear(3, 2)
    tr = Trainer(lin.parameters(), "sgd", {"learning_rate": 0.1})
    assert tr.loss_scaler is None
    loss = lin(torch.ones(2, 3)).sum()
    assert tr.scale_loss(loss) is loss
    tr.set_loss_scaler(amp.LossScaler(init_scale=32.0))
    assert float(tr.scale_loss(torch.tensor(2.0))) == 64.0
    tprof.reset()
    tprof.start()
    try:
        lin(torch.ones(2, 3)).sum().backward()
        lin.bias.grad.fill_(float("inf"))
        tr.step(2)
    finally:
        tprof.stop()
    names = [e["name"] for e in tprof.snapshot_events()]
    assert "resilience::loss_scale(overflow)" in names
    assert tr.loss_scaler.loss_scale == 16.0
    tprof.reset()
    tr.set_loss_scaler(None)
    lin(torch.ones(2, 3)).sum().backward()
    tr.step(2)                      # no scaler: a plain step
    assert lin.weight.grad is None


def test_cross_entropy_of_bf16_logits_matches_jax():
    """The loss takes its log-sum-exp in f32: bf16 logits give the JAX
    package's f32 loss (the same f32 arithmetic on the same bf16 values)."""
    rng = np.random.RandomState(0)
    pred = (rng.randn(2, 5, 300) * 4).astype(np.float32)
    label = rng.randint(0, 300, size=(2, 5))
    ref = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
        mx.np.array(pred).astype("bfloat16"), mx.np.array(label))
    out = tloss.SoftmaxCrossEntropyLoss()(
        torch.from_numpy(pred).to(torch.bfloat16), torch.from_numpy(label))
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), atol=1e-5,
                               rtol=1e-6)
