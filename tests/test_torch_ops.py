"""The port's serving ops (``mxnet_tpu_torch.ops.nn``) against their
``mxnet_tpu.ops.nn`` counterparts on the same numpy inputs.

Copies and gathers must agree exactly (the KV-cache writes, int8 values
and scales included: both round half to even). Arithmetic ops are held to
f32 tolerances (atol 1e-6 / rtol 1e-6): the two frameworks may fuse or
order the few operations differently.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import numpy as mnp
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as tops


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.numpy()


@pytest.mark.parametrize("t,sp", [(1, [0, 5, 15]), (4, [0, 3, 12]),
                                  (3, [14, 0, 15])],
                         ids=["decode", "block", "past_the_end"])
def test_kv_cache_write_exact(t, sp):
    rng = np.random.RandomState(0)
    cache = rng.randn(3, 2, 16, 8).astype(np.float32)
    new = rng.randn(3, 2, t, 8).astype(np.float32)
    sp = np.array(sp, np.int32)
    ref = jops.kv_cache_write(mnp.array(cache), mnp.array(new),
                              mnp.array(sp))
    ring = torch.from_numpy(cache.copy())
    out = tops.kv_cache_write(ring, torch.from_numpy(new),
                              torch.from_numpy(sp))
    assert out is ring  # in place
    np.testing.assert_array_equal(out.numpy(), _np(ref))


@pytest.mark.parametrize("t,sp", [(1, [0, 5, 15]), (4, [0, 3, 12]),
                                  (3, [14, 0, 15])],
                         ids=["decode", "block", "past_the_end"])
def test_kv_cache_write_q_exact(t, sp):
    rng = np.random.RandomState(1)
    cq = rng.randint(-127, 128, size=(3, 2, 16, 8)).astype(np.int8)
    cs = rng.uniform(1e-3, 1e-2, size=(3, 2, 16)).astype(np.float32)
    new = (rng.randn(3, 2, t, 8) * 3).astype(np.float32)
    # exact halves after scaling: round-half-to-even must agree
    new[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    sp = np.array(sp, np.int32)
    rq, rs = jops.kv_cache_write_q(mnp.array(cq), mnp.array(cs),
                                   mnp.array(new), mnp.array(sp))
    oq, os_ = tops.kv_cache_write_q(torch.from_numpy(cq.copy()),
                                    torch.from_numpy(cs.copy()),
                                    torch.from_numpy(new),
                                    torch.from_numpy(sp))
    assert oq.dtype == torch.int8 and os_.dtype == torch.float32
    np.testing.assert_array_equal(oq.numpy(), _np(rq))
    np.testing.assert_array_equal(os_.numpy(), _np(rs))


def test_kv_cache_write_longer_than_ring_raises():
    with pytest.raises(MXNetError, match="ring"):
        tops.kv_cache_write(torch.zeros(1, 1, 4, 2), torch.zeros(1, 1, 5, 2),
                            torch.zeros(1, dtype=torch.int32))


def test_rope_positions_exact():
    rng = np.random.RandomState(2)
    cos = rng.randn(32, 4).astype(np.float32)
    sin = rng.randn(32, 4).astype(np.float32)
    sp = np.array([0, 9, 27], np.int32)
    rc, rs = jops.rope_positions(mnp.array(cos), mnp.array(sin),
                                 mnp.array(sp), 5)
    oc, os_ = tops.rope_positions(torch.from_numpy(cos),
                                  torch.from_numpy(sin),
                                  torch.from_numpy(sp), 5)
    assert tuple(oc.shape) == (3, 1, 5, 4)
    np.testing.assert_array_equal(oc.numpy(), _np(rc))
    np.testing.assert_array_equal(os_.numpy(), _np(rs))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm(eps):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 64).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(64,)).astype(np.float32)
    ref = jops.rms_norm(mnp.array(x), mnp.array(g), eps=eps)
    out = tops.rms_norm(torch.from_numpy(x), torch.from_numpy(g), eps=eps)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6, rtol=1e-6)


def test_gather_positions_exact():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 7, 11).astype(np.float32)
    idx = np.array([6, 0, 3], np.int32)
    ref = jops.gather_positions(mnp.array(x), mnp.array(idx))
    out = tops.gather_positions(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), _np(ref))


def test_silu_activation():
    x = np.random.RandomState(5).randn(4, 33).astype(np.float32)
    ref = jops.activation(mnp.array(x), "silu")
    out = tops.activation(torch.from_numpy(x), "silu")
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6, rtol=1e-6)
    with pytest.raises(MXNetError):
        tops.activation(torch.from_numpy(x), "softsign")


def test_quantized_dense_weight_only():
    """The port's int8 dense is the JAX package's non-TPU formulation
    (dequantize, f32 gemm, scale the output)."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 16).astype(np.float32)
    w = rng.randint(-127, 128, size=(24, 16)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, size=(24,)).astype(np.float32)
    ref = jops.quantized_dense(mnp.array(x), mnp.array(w), mnp.array(s))
    out = tops.quantized_dense(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(s))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_cached_attention_baseline_not_ported():
    """The baseline mul+reduce ``cached_attention`` is ported (the name
    stays from when it raised): over unexpanded GQA rings it equals the JAX
    op over the expanded rings the JAX cache path gives it, to 1e-5 of the
    largest |output|, and it refuses int8 rings."""
    rng = np.random.RandomState(9)
    q = rng.randn(2, 4, 3, 8).astype(np.float32)
    k = rng.randn(2, 2, 16, 8).astype(np.float32)
    v = rng.randn(2, 2, 16, 8).astype(np.float32)
    sp = np.array([0, 9], np.int32)
    ref = _np(jops.cached_attention(
        mnp.array(q), mnp.array(np.repeat(k, 2, axis=1)),
        mnp.array(np.repeat(v, 2, axis=1)), mnp.array(sp)))
    out = tops.cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(sp),
                                path="baseline").numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    z = torch.zeros(1, 2, 1, 4)
    with pytest.raises(MXNetError, match="int8"):
        tops.cached_attention(z, z, z, torch.zeros(1, dtype=torch.int32),
                              path="baseline", k_scale=z[..., 0],
                              v_scale=z[..., 0])


def test_relu_activation():
    x = np.random.RandomState(7).randn(4, 33).astype(np.float32)
    ref = jops.activation(mnp.array(x), "relu")
    out = tops.activation(torch.from_numpy(x), "relu")
    np.testing.assert_array_equal(out.numpy(), _np(ref))


@pytest.mark.parametrize("stride,pad,bias",
                         [(1, 1, False), (2, 3, True), (2, 0, True)],
                         ids=["3x3", "stem_like", "strided_unpadded"])
def test_convolution_matches_jax(stride, pad, bias):
    """NCHW data, (O, I, kh, kw) weight in both packages."""
    rng = np.random.RandomState(8)
    k = 7 if pad == 3 else 3
    x = rng.randn(2, 4, 15, 13).astype(np.float32)
    w = rng.randn(6, 4, k, k).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if bias else None
    ref = jops.convolution(mnp.array(x), mnp.array(w),
                           None if b is None else mnp.array(b),
                           kernel=(k, k), stride=(stride, stride),
                           pad=(pad, pad), num_filter=6,
                           no_bias=b is None)
    out = tops.convolution(torch.from_numpy(x), torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b),
                           stride, pad)
    assert tuple(out.shape) == _np(ref).shape
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)
