"""The port's fused 1x1-conv pair against the JAX package's.

The JAX side runs the real TPU kernel through the Pallas interpreter
(``conv1x1_pair(..., interpret=True)``) at ``"highest"`` matmul precision,
as ``tests/test_conv1x1_pair.py`` does; the port's side is its plain
version, which the wrapper takes for CPU tensors. Inputs come from numpy
seeds. Tolerance 2e-5 (rtol and atol), the JAX test's own bound against its
numpy oracle: the same f32 arithmetic, summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.conv1x1 import conv1x1_pair as jax_pair
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.hopper import conv1x1

# lead, c1, cm, cout, affine, residual, return_mid: the five CASES of
# tests/test_conv1x1_pair.py, then the fused ResNet boundary (mid written)
CASES = [
    ((256,), 512, 128, 512, False, False, False),   # stage2 pair shape
    ((64,), 64, 256, 64, False, False, False),      # stage1 pair shape
    ((4, 49), 512, 128, 512, True, False, False),   # folded-BN affines
    ((200,), 128, 512, 128, True, True, False),     # boundary motif + skip
    ((33,), 256, 128, 192, True, False, False),     # cout != c1, ragged rows
    ((2, 7, 7), 128, 512, 128, True, True, True),   # boundary, mid returned
]


def _inputs(lead, c1, cm, cout, affine, residual, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, c1).astype(np.float32) * 0.5
    w1 = (rng.randn(c1, cm) * (2.0 / c1) ** 0.5).astype(np.float32)
    w2 = (rng.randn(cm, cout) * (2.0 / cm) ** 0.5).astype(np.float32)
    if affine:
        aff = [(rng.rand(cm) + 0.5).astype(np.float32),
               (rng.randn(cm) * 0.1).astype(np.float32),
               (rng.rand(cout) + 0.5).astype(np.float32),
               (rng.randn(cout) * 0.1).astype(np.float32)]
    else:
        aff = [None] * 4
    res = (rng.randn(*lead, cm).astype(np.float32) * 0.5
           if residual else None)
    return x, w1, w2, aff, res


def _jax(x, w1, w2, aff, res, return_mid):
    def j(a):
        return None if a is None else jnp.asarray(a)

    with jax.default_matmul_precision("highest"):
        out = jax_pair(j(x), j(w1), j(w2), *[j(a) for a in aff], j(res),
                       block_rows=32, return_mid=return_mid, interpret=True)
    if return_mid:
        return [np.asarray(o, np.float32) for o in out]
    return [np.asarray(out, np.float32)]


def _port(fn, x, w1, w2, aff, res, return_mid):
    def t(a):
        return None if a is None else torch.from_numpy(a)

    out = fn(t(x), t(w1), t(w2), *[t(a) for a in aff], t(res),
             return_mid=return_mid)
    outs = out if return_mid else (out,)
    return [o.to(torch.float32).numpy() for o in outs]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_kernel(case):
    *shape, return_mid = case
    x, w1, w2, aff, res = _inputs(*shape)
    want = _jax(x, w1, w2, aff, res, return_mid)
    got = _port(conv1x1.conv1x1_pair_torch, x, w1, w2, aff, res, return_mid)
    lead, cout, cm = shape[0], shape[3], shape[2]
    assert got[0].shape == (*lead, cout)
    if return_mid:
        assert got[1].shape == (*lead, cm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_wrapper_takes_the_plain_version_on_cpu():
    x, w1, w2, aff, res = _inputs(*CASES[-1][:-1])
    n0 = conv1x1.launch_count()
    got = _port(conv1x1.conv1x1_pair, x, w1, w2, aff, res, True)
    assert conv1x1.last_path() == "torch"
    assert conv1x1.launch_count() == n0
    want = _port(conv1x1.conv1x1_pair_torch, x, w1, w2, aff, res, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    conv1x1.force_path("cuda")
    try:
        with pytest.raises(MXNetError, match="needs CUDA tensors"):
            _port(conv1x1.conv1x1_pair, x, w1, w2, aff, res, True)
    finally:
        conv1x1.force_path(None)
    with pytest.raises(ValueError):
        conv1x1.force_path("tpu")


@pytest.mark.parametrize("fn", [conv1x1.conv1x1_pair,
                                conv1x1.conv1x1_pair_torch])
def test_return_mid_needs_a_residual(fn):
    x, w1, w2, aff, _ = _inputs((8,), 16, 32, 16, True, False)
    with pytest.raises(ValueError, match="return_mid requires residual"):
        _port(fn, x, w1, w2, aff, None, True)


def test_bf16_close_to_f32_oracle():
    """bf16 in, bf16 out, every rounding of the kernel (h to bf16 before the
    second product, the bf16 affines widened to f32): within 5e-2 of the
    f32 answer relative to its largest value, as the JAX bf16 test bounds
    its kernel, and close to the JAX kernel run in bf16."""
    rng = np.random.RandomState(1)
    x = rng.randn(96, 512).astype(np.float32) * 0.5
    w1 = (rng.randn(512, 128) * 0.06).astype(np.float32)
    w2 = (rng.randn(128, 512) * 0.12).astype(np.float32)
    res = rng.randn(96, 128).astype(np.float32) * 0.5
    aff = [(rng.rand(128) + 0.5).astype(np.float32),
           (rng.randn(128) * 0.1).astype(np.float32),
           (rng.rand(512) + 0.5).astype(np.float32),
           (rng.randn(512) * 0.1).astype(np.float32)]
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, w1, w2, res)]
    baff = [torch.from_numpy(a).to(torch.bfloat16) for a in aff]
    y, mid = conv1x1.conv1x1_pair(bf[0], bf[1], bf[2], *baff,
                                  residual=bf[3], return_mid=True)
    assert y.dtype == mid.dtype == torch.bfloat16
    oracle = conv1x1.conv1x1_pair_torch(*[torch.from_numpy(a) for a in
                                          (x, w1, w2)],
                                        *[torch.from_numpy(a) for a in aff],
                                        residual=torch.from_numpy(res))
    err = (y.float() - oracle).abs().max() / oracle.abs().max()
    assert float(err) < 5e-2, float(err)
    jy, jmid = jax_pair(*[jnp.asarray(a, jnp.bfloat16)
                          for a in (x, w1, w2, *aff, res)],
                        block_rows=32, return_mid=True, interpret=True)
    for ours, theirs in ((y, jy), (mid, jmid)):
        theirs = np.asarray(theirs, np.float32)
        diff = np.abs(ours.float().numpy() - theirs).max()
        assert diff <= 2e-2 * np.abs(theirs).max(), diff


# ResNet-50's block boundaries at batch 32, 224 x 224: (M, C1 = Cout, Cm)
STAGES = [(32 * 56 * 56, 64, 256), (32 * 28 * 28, 128, 512),
          (32 * 14 * 14, 256, 1024), (32 * 7 * 7, 512, 2048)]


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_split_plan_fills_an_h100(stage):
    """On 132 SMs: one slice where row tiles already fill the card (stages
    1-2); at stages 3-4 the fewest slices that give ``BLOCKS_PER_SM`` blocks
    a SM (at least one); slices of whole 64-wide chunks but the last; an
    f32 partial y a slice."""
    m, c, cm = STAGES[stage - 1]
    plan = conv1x1.split_plan(m, cm, c, sm_count=132)
    assert plan.blocks >= 132
    assert plan.block_cols >= c
    assert plan.grid[:2] == (-(-m // plan.block_rows), 1)
    if stage <= 2:
        assert plan.slices == 1 and plan.workspace_bytes == 0
    else:
        assert plan.slices > 1
        assert plan.workspace_bytes == plan.slices * m * c * 4
        # the fewest slices that give BLOCKS_PER_SM blocks a SM
        assert plan.grid[0] * (plan.slices - 1) < 132 * conv1x1.BLOCKS_PER_SM
    widths = [min(plan.slice_cols, cm - z * plan.slice_cols)
              for z in range(plan.slices)]
    assert sum(widths) == cm and min(widths) > 0
    assert all(w % 64 == 0 for w in widths[:-1])


def test_split_plan_ragged_last_slice():
    plan = conv1x1.split_plan(4000, 1000, 256, sm_count=132)
    assert plan.slices > 1 and plan.slice_cols % 64 == 0
    last = 1000 - (plan.slices - 1) * plan.slice_cols
    assert 0 < last < plan.slice_cols and last % 64  # not whole chunks


def _split_sums(x, w1, w2, aff, res, plan):
    """The kernel's order of sums, in torch: h a 64-wide chunk at a time
    with its epilogue, rounded to x's dtype; each slice's partial y in f32,
    chunk after chunk; the partials added in slice order; then the affine.
    Returns (y, mid)."""
    f32 = torch.float32
    s1, b1, s2, b2 = [torch.from_numpy(a) for a in aff]
    xt, w1t, w2t, rt = [torch.from_numpy(a) for a in (x, w1, w2, res)]
    cm = w1t.shape[1]
    partials, mids = [], []
    for z in range(plan.slices):
        part = torch.zeros(xt.shape[0], w2t.shape[1])
        for c0 in range(z * plan.slice_cols,
                        min(cm, (z + 1) * plan.slice_cols), 64):
            ch = slice(c0, min(cm, c0 + 64))
            h = (xt.to(f32) @ w1t[:, ch].to(f32)) * s1[ch] + b1[ch] + rt[:, ch]
            h = torch.relu(h).to(xt.dtype)
            mids.append(h)
            part = part + h.to(f32) @ w2t[ch].to(f32)
        partials.append(part)
    acc = partials[0]
    for part in partials[1:]:
        acc = acc + part
    y = torch.relu(acc * s2 + b2).to(xt.dtype)
    return y.numpy(), torch.cat(mids, 1).numpy()


@pytest.mark.parametrize("sm_count", [132, 4], ids=["32_slices", "4_slices"])
def test_split_order_matches_jax_kernel(sm_count):
    """Stage-4 widths (C1 512, Cm 2048, Cout 512) at M = 49: the split
    kernel's order of sums stays within the kernel's f32 tolerance (1e-4,
    as on the card) of the JAX kernel in interpret mode. One chunk a slice
    on 132 SMs, eight on 4."""
    x, w1, w2, aff, res = _inputs((49,), 512, 2048, 512, True, True, seed=3)
    plan = conv1x1.split_plan(49, 2048, 512, sm_count)
    assert plan.slices == {132: 32, 4: 4}[sm_count]
    got = _split_sums(x, w1, w2, aff, res, plan)
    want = _jax(x, w1, w2, aff, res, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
