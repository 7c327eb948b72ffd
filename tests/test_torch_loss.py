"""All 15 of the port's Gluon losses against the JAX package's classes:
the forward and the gradient of each floating input, from the same seeded
numpy inputs, to 1e-5 of the largest value (CTC to 1e-4). MXNet's
``loss.backward()`` seeds ones; the port's is ``loss.sum().backward()``.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd
from mxnet_tpu import np as mnp
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss


def _inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "x": f(4, 3, 5), "y": f(4, 3, 5), "sw": rng.uniform(
            0.5, 2, (4, 1, 1)).astype(np.float32),
        "logits": f(4, 6), "cls": rng.randint(0, 6, 4).astype(np.float32),
        "probs": rng.dirichlet(np.ones(6), 4).astype(np.float32),
        "bin": rng.randint(0, 2, (4, 6)).astype(np.float32),
        "sig": rng.uniform(0.05, 0.95, (4, 6)).astype(np.float32),
        "signed": (rng.randint(0, 2, (4, 6)) * 2 - 1).astype(np.float32),
        "pos_w": rng.uniform(0.5, 3, (6,)).astype(np.float32),
        "rate": rng.uniform(0.5, 3, (4, 6)).astype(np.float32),
        "count": rng.poisson(2.0, (4, 6)).astype(np.float32),
        "a": f(5, 8), "b": f(5, 8), "c": f(5, 8),
        "pm": rng.choice([-1.0, 1.0], 5).astype(np.float32),
        "ctc": f(3, 12, 5),
        "ctc_label": np.array([[1, 2, 1, 0], [3, 3, 0, 0], [2, 1, 3, 2]],
                              np.float32),
    }


# (name, ctor kwargs, call: input keys, the positions that get gradients)
CASES = [
    ("L2Loss", {}, ["x", "y"], [0]),
    ("L2Loss", {"weight": 0.5, "batch_axis": 1}, ["x", "y"], [0]),
    ("L1Loss", {}, ["x", "y", "sw"], [0]),
    ("SoftmaxCrossEntropyLoss", {}, ["logits", "cls"], [0]),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
     ["logits", "probs"], [0]),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "weight": 2.0},
     ["logits", "cls"], [0]),
    ("SigmoidBinaryCrossEntropyLoss", {}, ["logits", "bin"], [0]),
    ("SigmoidBinaryCrossEntropyLoss", {}, ["logits", "bin", None, "pos_w"],
     [0]),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
     ["sig", "bin"], [0]),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
     ["sig", "bin", None, "pos_w"], [0]),
    ("KLDivLoss", {}, ["logits", "probs"], [0]),
    ("KLDivLoss", {"from_logits": False}, ["logits", "probs"], [0]),
    ("HuberLoss", {"rho": 0.7}, ["x", "y"], [0]),
    ("HingeLoss", {"margin": 1.5}, ["logits", "signed"], [0]),
    ("SquaredHingeLoss", {}, ["logits", "signed"], [0]),
    ("LogisticLoss", {}, ["logits", "signed"], [0]),
    ("LogisticLoss", {"label_format": "binary"}, ["logits", "bin"], [0]),
    ("TripletLoss", {"margin": 0.5}, ["a", "b", "c"], [0, 1, 2]),
    ("PoissonNLLLoss", {}, ["logits", "count"], [0]),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     ["rate", "count"], [0]),
    ("CosineEmbeddingLoss", {"margin": 0.1}, ["a", "b", "pm"], [0, 1]),
    ("SDMLLoss", {"smoothing_parameter": 0.2}, ["a", "b"], [0, 1]),
    ("CTCLoss", {}, ["ctc", "ctc_label"], [0]),
    ("CTCLoss", {"layout": "TNC", "label_layout": "TN"},
     ["ctc", "ctc_label"], [0]),
]


def _args(keys, name, layout):
    d = _inputs()
    out = []
    for k in keys:
        a = None if k is None else d[k]
        if a is not None and name == "CTCLoss" and layout:
            a = np.ascontiguousarray(np.swapaxes(a, 0, 1))
        out.append(a)
    return out


def _jax(name, kwargs, args, grad_at):
    arrs = [None if a is None else mnp.array(a) for a in args]
    for i in grad_at:
        arrs[i].attach_grad()
    with autograd.record():
        loss = getattr(jloss, name)(**kwargs)(*arrs)
    loss.backward()
    return loss.asnumpy(), [arrs[i].grad.asnumpy() for i in grad_at]


def _port(name, kwargs, args, grad_at):
    ts = [None if a is None else torch.from_numpy(a.copy()) for a in args]
    for i in grad_at:
        ts[i].requires_grad_()
    loss = getattr(tloss, name)(**kwargs)(*ts)
    loss.sum().backward()
    return loss.detach().numpy(), [ts[i].grad.numpy() for i in grad_at]


@pytest.mark.parametrize("name,kwargs,keys,grad_at", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_loss_matches_jax(name, kwargs, keys, grad_at):
    args = _args(keys, name, kwargs.get("layout") == "TNC")
    want, want_g = _jax(name, kwargs, args, grad_at)
    got, got_g = _port(name, kwargs, args, grad_at)
    tol = 1e-4 if name == "CTCLoss" else 1e-5
    assert got.shape == want.shape
    for a, b in [(got, want)] + list(zip(got_g, want_g)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))


def test_ctc_lengths_and_bad_layouts():
    d = _inputs()
    pred, label = d["ctc"], d["ctc_label"]
    pl = np.array([12, 9, 10], np.float32)
    ll = np.array([3, 1, 4], np.float32)
    jl = jloss.CTCLoss()(mnp.array(pred), mnp.array(label), mnp.array(pl),
                         mnp.array(ll)).asnumpy()
    tl = tloss.CTCLoss()(torch.from_numpy(pred), torch.from_numpy(label),
                         torch.from_numpy(pl), torch.from_numpy(ll))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())
    with pytest.raises(MXNetError, match="layout"):
        tloss.CTCLoss(layout="NCT")
    with pytest.raises(MXNetError, match="label_format"):
        tloss.LogisticLoss(label_format="x")
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss
