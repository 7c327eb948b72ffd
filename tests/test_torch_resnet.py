"""The port's ResNets, ``fuse_resnet_v1`` and image serving against the JAX
package's.

Weights come from the JAX ``resnet50_v1`` (Xavier init, then one
train-mode pass that moves the BatchNorm running statistics off their
initial values, as ``tests/test_pallas_fuse.py`` does) and are carried
across with ``load_reference_params``; images come from numpy. The JAX
fused model runs its Pallas kernel through the interpreter at "highest"
matmul precision; the port's runs the kernel's plain version (CPU tensors).

Tolerances, relative to the largest |logit|: 1e-4 in f32, the JAX fuse
test's own bound (the same f32 arithmetic, summed in other orders through
50 layers); in bf16, argmax agreement, as the JAX bf16 test asks.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib import pallas_fuse as jax_fuse
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.pallas_fuse import (FusedResNetV1,
                                                 fuse_resnet_v1)
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.ops.hopper import conv1x1
from mxnet_tpu_torch.serve import InferenceSession

HW = 64
_CACHE = {}


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _models():
    """(JAX net after burn-in, its params, port net with them, images)."""
    if not _CACHE:
        mx.random.seed(0)
        net = gluon.model_zoo.vision.resnet50_v1()
        net.initialize(init="xavier")
        rng = np.random.RandomState(0)
        with autograd.record():
            net(mnp.array(rng.uniform(-1, 1, (2, 3, HW, HW)).astype("f")))
        params = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        port = vision.load_reference_params(
            vision.resnet50_v1(device="cpu"), params)
        x = rng.uniform(-1, 1, (2, 3, HW, HW)).astype(np.float32)
        with autograd.predict_mode():
            ref = net(mnp.array(x)).asnumpy()
        _CACHE.update(net=net, params=params, port=port, x=x, ref=ref)
    return _CACHE


def test_load_reference_params_carries_every_entry():
    m = _models()
    params, port = m["params"], m["port"]
    assert len(params) == 267
    state = port.state_dict()
    assert len(state) == 267
    for name, t in state.items():
        jname = name
        if name.rsplit(".", 1)[-1] in ("weight", "bias") and isinstance(
                port.get_submodule(name.rsplit(".", 1)[0]), tnn.BatchNorm):
            jname = name[:-len("weight")] + "gamma" \
                if name.endswith("weight") else name[:-len("bias")] + "beta"
        np.testing.assert_array_equal(t.numpy(), params[jname])
    # the BN statistics moved off their initial values in the burn-in
    assert not np.allclose(params["features.1.running_var"], 1.0)
    bad = dict(params)
    bad.pop("output.bias")
    with pytest.raises(MXNetError, match="missing"):
        vision.load_reference_params(vision.resnet50_v1(device="cpu"), bad)
    bad = dict(params, extra=np.zeros(1))
    with pytest.raises(MXNetError, match="unused"):
        vision.load_reference_params(vision.resnet50_v1(device="cpu"), bad)


def test_unfused_forward_matches_jax():
    m = _models()
    with torch.no_grad():
        got = m["port"](torch.from_numpy(m["x"])).numpy()
    assert got.shape == (2, 1000)
    assert _rel(got, m["ref"]) < 1e-4


@pytest.mark.parametrize("use_pallas", [True, False])
def test_fused_f32_matches_jax_fused(use_pallas):
    m = _models()
    jax_fuse.use_interpret(True)
    try:
        jf = jax_fuse.fuse_resnet_v1(m["net"], dtype="float32",
                                     block_rows=32, use_pallas=use_pallas)
        with jax.default_matmul_precision("highest"):
            want = jf(mnp.array(m["x"])).asnumpy()
    finally:
        jax_fuse.use_interpret(False)
    fused = fuse_resnet_v1(m["port"], dtype="float32", block_rows=32,
                           use_pallas=use_pallas)
    assert isinstance(fused, FusedResNetV1)
    n0 = conv1x1.launch_count()
    with torch.no_grad():
        got = fused(torch.from_numpy(m["x"]))
    assert got.dtype == torch.float32
    assert conv1x1.launch_count() == n0  # CPU: the plain version
    assert _rel(got.numpy(), want) < 1e-4
    assert _rel(got.numpy(), m["ref"]) < 1e-4


def test_fused_bf16_agrees_on_argmax():
    m = _models()
    fused = fuse_resnet_v1(m["port"], use_pallas=True)  # bf16 by default
    with torch.no_grad():
        got = fused(torch.from_numpy(m["x"]))
    assert got.dtype == torch.float32
    assert conv1x1.last_path() == "torch"
    assert (got.numpy().argmax(-1) == m["ref"].argmax(-1)).all()
    assert _rel(got.numpy(), m["ref"]) < 5e-2


def test_session_pads_images_on_the_batch_axis_only():
    m = _models()
    fused = fuse_resnet_v1(m["port"], dtype="float32", use_pallas=True)
    sess = InferenceSession(fused, batch_buckets=(1, 8))
    assert sess.device == torch.device("cpu")  # found from the buffers
    assert sess.warmup(m["x"][:1]) == 2
    x5 = np.concatenate([m["x"], m["x"], m["x"][:1]])
    seen = []
    handle = fused.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
    try:
        out = sess.predict(x5)
    finally:
        handle.remove()
    assert seen == [(8, 3, HW, HW)]
    assert tuple(out.shape) == (5, 1000)
    sess.assert_no_recompiles()
    with torch.no_grad():
        direct = fused(torch.from_numpy(x5))
    np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-5 * float(direct.abs().max()))


def test_unfusable_models_raise():
    with pytest.raises(MXNetError):
        fuse_resnet_v1(vision.resnet50_v2(device="cpu"))
    with pytest.raises(MXNetError):
        fuse_resnet_v1(vision.resnet18_v1(device="cpu"))
    with pytest.raises(MXNetError):
        fuse_resnet_v1(vision.get_resnet(1, 50, thumbnail=True,
                                         device="cpu"))
    with pytest.raises(MXNetError, match="dtype"):
        fuse_resnet_v1(vision.resnet50_v1(device="cpu"), dtype="int8")


def test_get_resnet_rejects_bad_arguments():
    with pytest.raises(MXNetError, match="depth"):
        vision.get_resnet(1, 42, device="cpu")
    with pytest.raises(MXNetError, match="version"):
        vision.get_resnet(3, 50, device="cpu")
    with pytest.raises(MXNetError, match="pretrained"):
        vision.get_resnet(1, 50, pretrained=True, device="cpu")
    trandom.seed(3)
    a = vision.resnet18_v1(device="cpu")
    trandom.seed(3)
    b = vision.resnet18_v1(device="cpu")
    assert not a.training and not any(p.requires_grad
                                      for p in a.parameters())
    for (name, ta), tb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(ta, tb), name


def test_v2_carries_fix_gamma_without_reading_gamma():
    """ResNetV2's first BatchNorm has scale=False (MXNet's fix_gamma): its
    gamma is not read, so a gamma of 5 in the JAX params changes neither
    model; the logits match."""
    mx.random.seed(1)
    net = gluon.model_zoo.vision.resnet18_v2(classes=10)
    net.initialize(init="xavier")
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    with autograd.record():
        net(mnp.array(x))
    net.features[0].gamma.set_data(mnp.array(np.full(3, 5.0, "f")))
    params = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    port = vision.load_reference_params(
        vision.resnet18_v2(classes=10, device="cpu"), params)
    assert port.features[0].weight is None
    with autograd.predict_mode():
        want = net(mnp.array(x)).asnumpy()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-4


def test_batchnorm_train_step_updates_running_stats_as_jax():
    """One train-mode step: the output and the running statistics (m=0.9,
    unbiased variance) as the JAX BatchNorm gives them."""
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 6, 5, 5) * 2 + 1).astype(np.float32)
    gamma = (rng.rand(6) + 0.5).astype(np.float32)
    beta = rng.randn(6).astype(np.float32)
    rm = rng.randn(6).astype(np.float32)
    rv = (rng.rand(6) + 0.5).astype(np.float32)
    jbn = gluon.nn.BatchNorm(in_channels=6)
    jbn.initialize()
    for p, v in ((jbn.gamma, gamma), (jbn.beta, beta),
                 (jbn.running_mean, rm), (jbn.running_var, rv)):
        p.set_data(mnp.array(v))
    with autograd.record():
        jout = jbn(mnp.array(x)).asnumpy()
    tbn = tnn.BatchNorm(in_channels=6)
    with torch.no_grad():
        for t, v in ((tbn.weight, gamma), (tbn.bias, beta),
                     (tbn.running_mean, rm), (tbn.running_var, rv)):
            t.copy_(torch.from_numpy(v))
    tbn.train()
    tout = tbn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               jbn.running_mean.data().asnumpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               jbn.running_var.data().asnumpy(),
                               rtol=1e-6, atol=1e-6)
    tbn.eval()
    with autograd.predict_mode():
        jeval = jbn(mnp.array(x)).asnumpy()
    np.testing.assert_allclose(tbn(torch.from_numpy(x)).detach().numpy(),
                               jeval, rtol=1e-5, atol=1e-5)
