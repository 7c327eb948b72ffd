"""All 17 of the port's optimizers against the JAX package's rules.

Each runs four updates through the per-parameter API
(``opt.update(index, weight, grad, state)``, MXNet's semantics: update
counts per index, ``rescale_grad`` then ``clip_gradient``, ``wd``, the
learning rate from a ``FactorScheduler``) on two weights with seeded numpy
gradients, in both packages. Weights and every state agree to 1e-6
(relative, and absolute at that scale). SGLD's noise is the port's own
stream by design (a ``torch.Generator``, as ``ops.nn.sample_step``), so it
is held on its deterministic part, and the noise on its moments.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import lr_scheduler as jlr
from mxnet_tpu import np as mnp
from mxnet_tpu import optimizer as jopt
from mxnet_tpu_torch import lr_scheduler as tlr
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError

COMMON = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.8}
CASES = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "adam": {"learning_rate": 0.01},
    "adamw": {"learning_rate": 0.01},
    "rmsprop": {"learning_rate": 0.01, "centered": True,
                "clip_weights": 2.0},
    "adagrad": {"learning_rate": 0.1},
    "adadelta": {"learning_rate": 1.0},
    "adamax": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "ftrl": {"learning_rate": 0.1, "lamda1": 0.01},
    "ftml": {"learning_rate": 0.01},
    "signum": {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 0.01},
    "lars": {"learning_rate": 0.1, "momentum": 0.9},
    "lamb": {"learning_rate": 0.01, "lower_bound": 0.1, "upper_bound": 10},
    "lans": {"learning_rate": 0.01},
    "sgld": {"learning_rate": 0.01},
    "dcasgd": {"learning_rate": 0.1, "momentum": 0.5},
}
SHAPES = [(5, 7), (11,)]
UPDATES = 4


def _arrays():
    rng = np.random.RandomState(0)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[(rng.randn(*s) * 2).astype(np.float32) for s in SHAPES]
          for _ in range(UPDATES)]
    return ws, gs


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _run_jax(name, kwargs, ws, gs):
    opt = jopt.create(name, lr_scheduler=jlr.FactorScheduler(2, 0.5),
                      **kwargs, **COMMON)
    weights = [mnp.array(w) for w in ws]
    states = [opt.create_state(i, w) for i, w in enumerate(weights)]
    for grads in gs:
        for i, (w, g) in enumerate(zip(weights, grads)):
            opt.update(i, w, mnp.array(g), states[i])
    return ([w.asnumpy() for w in weights],
            [[s.asnumpy() for s in _flat(st)] for st in states])


def _run_port(name, kwargs, ws, gs, **extra):
    opt = topt.create(name, lr_scheduler=tlr.FactorScheduler(2, 0.5),
                      **kwargs, **COMMON, **extra)
    weights = [torch.from_numpy(w.copy()) for w in ws]
    states = [opt.create_state(i, w) for i, w in enumerate(weights)]
    for grads in gs:
        for i, (w, g) in enumerate(zip(weights, grads)):
            opt.update(i, w, torch.from_numpy(g), states[i])
    return ([w.numpy() for w in weights],
            [[s.numpy() for s in _flat(st)] for st in states])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_jax(name):
    ws, gs = _arrays()
    kwargs = CASES[name]
    if name == "sgld":
        return _check_sgld(ws, gs)
    jw, js = _run_jax(name, kwargs, ws, gs)
    tw, ts = _run_port(name, kwargs, ws, gs)
    for got, want in zip(tw, jw):
        _close(got, want)
    for s_got, s_want in zip(ts, js):
        assert len(s_got) == len(s_want)
        for got, want in zip(s_got, s_want):
            _close(got, want)
    assert not np.allclose(tw[0], ws[0])


def _check_sgld(ws, gs):
    """Deterministic part: SGLD minus its noise (redrawn from the same
    generator seed) equals SGD at half the learning rate in the JAX
    package. Noise: mean 0 and standard deviation sqrt(lr) over 2**16
    draws (5 standard errors; 2%), in both packages."""
    lr, shape = 0.01, (256, 256)
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    g = np.random.RandomState(2).randn(*shape).astype(np.float32)
    sched = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.8}
    t = torch.from_numpy(w.copy())
    opt = topt.SGLD(learning_rate=lr, **sched,
                    generator=torch.Generator().manual_seed(5))
    opt.update(0, t, torch.from_numpy(g), opt.create_state(0, t))
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(5)
                        ) * math.sqrt(lr)
    ref = mnp.array(w)
    jsgd = jopt.SGD(learning_rate=lr / 2, **sched)
    jsgd.update(0, ref, mnp.array(g), jsgd.create_state(0, ref))
    # p - 0.5 lr g' against p - (lr / 2) g': one rounding apart
    np.testing.assert_allclose((t - noise).numpy(), ref.asnumpy(),
                               rtol=0, atol=1e-6)
    jw = mnp.array(w)
    jsgld = jopt.SGLD(learning_rate=lr, **sched)
    jsgld.update(0, jw, mnp.array(g), jsgld.create_state(0, jw))
    for drawn in ((t.numpy() - ref.asnumpy()), jw.asnumpy() - ref.asnumpy()):
        drawn = drawn.astype(np.float64)
        assert abs(drawn.mean()) <= 5 * math.sqrt(lr / drawn.size)
        assert abs(drawn.std() / math.sqrt(lr) - 1) <= 0.02
    # the device stream by default: seeded, repeatable
    from mxnet_tpu_torch import random as trandom

    outs = []
    for _ in range(2):
        trandom.seed(9)
        t2 = torch.from_numpy(w.copy())
        topt.SGLD(learning_rate=lr).update(0, t2, torch.from_numpy(g), ())
        outs.append(t2)
    trandom.seed(0)
    assert torch.equal(outs[0], outs[1])


def test_rmsprop_plain_signum_without_momentum_and_aliases():
    ws, gs = _arrays()
    for name, kwargs in (("rmsprop", {"learning_rate": 0.01}),
                         ("signum", {"momentum": 0.0}),
                         ("signsgd", {"momentum": 0.0, "wd_lh": 0.1}),
                         ("sgd", {"momentum": 0.0}),
                         ("lamb", {"bias_correction": False}),
                         ("adam", {"correct_bias": False})):
        jw, _ = _run_jax(name, kwargs, ws, gs)
        tw, _ = _run_port(name, kwargs, ws, gs)
        for got, want in zip(tw, jw):
            _close(got, want)
    assert isinstance(topt.create("signsgd"), topt.Signum)
    with pytest.raises(MXNetError, match="unknown optimizer"):
        topt.create("nope")
    with pytest.raises(MXNetError, match="A.7"):
        topt.SGD(lazy_update=True)


def test_updater_and_multi_precision_match_jax():
    """``Updater`` makes each index's state on first use; with
    ``multi_precision`` a float16 weight is updated through an f32 master,
    as in the JAX package. ``get_states``/``set_states`` round-trip."""
    ws, gs = _arrays()
    jopt_ = jopt.create("adam", learning_rate=0.01, multi_precision=True)
    topt_ = topt.create("adam", learning_rate=0.01, multi_precision=True)
    jup, tup = jopt.get_updater(jopt_), topt.get_updater(topt_)
    jws = [mnp.array(w).astype("float16") for w in ws]
    tws = [torch.from_numpy(w).half() for w in ws]
    for grads in gs:
        for i, g in enumerate(grads):
            jup(i, mnp.array(g).astype("float16"), jws[i])
            tup(i, torch.from_numpy(g).half(), tws[i])
    for got, want in zip(tws, jws):
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    master = tup.states[0][0]
    assert master.dtype == torch.float32
    _close(master.numpy(), jup.states[0][0].asnumpy())
    blob = tup.get_states()
    fresh = topt.get_updater(topt.create("adam", learning_rate=0.01,
                                         multi_precision=True))
    fresh.set_states(blob)
    for a, b in zip(_flat(fresh.states[1]), _flat(tup.states[1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    w = torch.from_numpy(ws[1]).half()
    fresh(1, torch.from_numpy(gs[0][1]).half(), w)
    assert fresh.states[1][0].dtype == torch.float32


def test_trainer_steps_every_optimizer():
    """``gluon.Trainer`` drives every rule (its own rescale and clip, then
    ``_update_raw``) and gives the per-parameter API's result."""
    from mxnet_tpu_torch.gluon import Trainer

    ws, gs = _arrays()
    for name in sorted(CASES):
        if name == "sgld":
            continue
        kwargs = dict(CASES[name], **COMMON)
        params = [torch.nn.Parameter(torch.from_numpy(w.copy()))
                  for w in ws]
        tr = Trainer(params, name, dict(
            kwargs, rescale_grad=1.0,
            lr_scheduler=tlr.FactorScheduler(2, 0.5)))
        for grads in gs:
            for p, g in zip(params, grads):
                p.grad = torch.from_numpy(g.copy())
            tr.step(2)   # rescale 1 / 2 == COMMON's 0.5
        want, _ = _run_port(name, CASES[name], ws, gs)
        for p, w in zip(params, want):
            _close(p.detach().numpy(), w)
