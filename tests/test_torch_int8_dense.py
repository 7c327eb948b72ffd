"""The port's int8 x int8 product (``ops/hopper/int8_dense``) and the int8
rung that runs it, against the JAX package's accelerator branch of
``quantized_dense``.

The JAX package takes that branch only where ``jax.default_backend()``
names a backend with int8 matrix units; here a wrapper makes it read
``"tpu"`` for the call alone, so XLA's CPU runs the branch itself (per-row
quantization, the int8 dot into int32, the rescale). The port's side is
``int8_dense_torch``, the plain version the CUDA kernel equals bit for bit
on the card (``tests/test_torch_cuda.py``).

Tolerance, in units in the last place of f32: 0 where the row's scale is
the same in both packages, else 2. When XLA compiles ``amax / 127`` it
folds the division by the constant into a multiplication by f32(1/127),
which is one ulp off the true quotient (the port's, like ``int8_scale``'s
for the KV rings) on about 3% of rows; that ulp of ``sx`` moves the
rescaled output by at most 2 ulps (no element of these inputs crosses a
rounding boundary of ``x / sx``). With a bias, XLA's CPU compiler also
contracts the last multiply and the bias add into one FMA, where the
kernel and the plain version round after each operation: there the two
agree within an ulp of the product term and of the sum.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy as mnp
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.serve import Generator as JaxGenerator
from mxnet_tpu_torch import int8_variants
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.hopper import int8_dense as i8
from mxnet_tpu_torch.serve import Generator
from mxnet_tpu_torch.serve import generate as tgen

_REAL_BACKEND = jax.default_backend


@contextlib.contextmanager
def _int8_matrix_unit():
    """``jax.default_backend()`` reads "tpu" inside the block only."""
    jax.default_backend = lambda: "tpu"
    try:
        yield
    finally:
        jax.default_backend = _REAL_BACKEND


def _jax_int8_branch(x, w, s, b=None):
    args = [mnp.array(x), mnp.array(w), mnp.array(s)]
    if b is not None:
        args.append(mnp.array(b))
    with _int8_matrix_unit():
        return jops.quantized_dense(*args).asnumpy()


def _ulps(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _inputs(case):
    rng = np.random.RandomState(7)
    lead, u, o = {"batched": ((2, 3), 16, 24), "ragged": ((5,), 30, 37),
                  "bias": ((4,), 64, 40), "zero_row": ((3,), 48, 16),
                  "ties": ((2,), 32, 8), "llama_width": ((4,), 4096, 64),
                  "prefill_rows": ((64,), 512, 96)}[case]
    x = rng.randn(*lead, u).astype(np.float32)
    if case == "zero_row":
        x[1] = 0.0
    if case == "ties":  # amax 127 -> sx = 1 exactly: x / sx hits .5 ties
        x[0] = 0.0
        x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    w = rng.randint(-127, 128, size=(o, u)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, size=o).astype(np.float32)
    b = rng.randn(o).astype(np.float32) if case == "bias" else None
    return x, w, s, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", ["batched", "ragged", "bias", "zero_row",
                                  "ties", "llama_width", "prefill_rows"])
def test_plain_version_matches_jax_accelerator_branch(case):
    x, w, s, b = _inputs(case)
    ref = _jax_int8_branch(x, w, s, b)
    out = i8.int8_dense_torch(_t(x), _t(w), _t(s), _t(b)).numpy()
    assert out.shape == ref.shape == (*x.shape[:-1], w.shape[0])
    x2 = x.reshape(-1, x.shape[-1])
    amax = np.abs(x2).max(axis=-1)
    true = np.maximum(amax / np.float32(127), np.float32(1e-8))
    folded = np.maximum(amax * np.float32(1 / 127), np.float32(1e-8))
    same = np.broadcast_to((true == folded)[:, None], (len(x2), w.shape[0]))
    if b is not None:
        # XLA's FMA skips the rounding of t = (acc * sx) * s: within an ulp
        # of t (and of the sum), which may be many ulps of a sum that
        # cancels
        t = i8.int8_dense_torch(_t(x), _t(w), _t(s)).numpy()
        gap = np.abs(out - ref)
        assert (gap <= np.spacing(np.abs(t)) + np.spacing(np.abs(ref))).all()
        out, ref = t, _jax_int8_branch(x, w, s)
    ulps = _ulps(out.reshape(same.shape), ref.reshape(same.shape))
    assert ulps[same].max(initial=0) == 0
    assert ulps.max() <= 2, ulps.max()


def test_quantize_rows_rounds_half_to_even_and_zero_rows():
    x = torch.zeros(2, 8)
    x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
    xq, sx = i8.quantize_rows_torch(x)
    assert xq[0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert sx[0].item() == 1.0
    assert sx[1].item() == np.float32(1e-8) and not xq[1].any()
    big = torch.tensor([[1000.0, -1000.0, 999.0]])
    assert i8.quantize_rows_torch(big)[0].tolist() == [[127, -127, 127]]


def quantization_bound(x, wf, qw, scale):
    """The most |int8 product - exact f32-weight product| can be, output
    by output: each x element lies within sx / 2 of its int8 value times
    sx and each weight within s / 2 of its own, so the error is at most
    sx / 2 * sum|w| + s / 2 * sum|xq * sx|."""
    xq, sx = i8.quantize_rows_torch(x)
    xd, sxd = xq.double() * sx.double(), sx.double()
    return (sxd / 2 * wf.double().abs().sum(1)[None, :]
            + scale.double()[None, :] / 2 * xd.abs().sum(1, keepdim=True))


@pytest.mark.parametrize("u,o", [(256, 48), (4096, 96)])
def test_plain_version_within_the_quantization_bound(u, o):
    """Against the f32-weight product in float64, every output lies within
    :func:`quantization_bound` (plus the f32 rounding of the rescale). The
    JAX docstring's ~1e-2 of the row's largest |output| is its typical
    size, not a bound: for normal activations against Llama's uniform
    weights it measured 0.9-1.3e-2 on these shapes."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, u).astype(np.float32))
    wf = torch.from_numpy(rng.uniform(-0.07, 0.07, (o, u)).astype(
        np.float32))
    scale = i8.int8_scale(wf.abs().amax(dim=1))
    qw = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(
        torch.int8)
    ref = x.double() @ wf.double().t()
    err = (i8.int8_dense_torch(x, qw, scale).double() - ref).abs()
    bound = quantization_bound(x, wf, qw, scale) + 1e-6 * ref.abs()
    assert (err <= bound).all(), float((err / bound).max())


ROW_RMS_LIMIT = 1.6e-2   # chip_smoke.py phase 3b's INT8_ROW_RMS_LIMIT


def _row_rms_error(out, ref):
    """The largest over rows of the RMS error over the RMS output."""
    return float(((out.double() - ref).norm(dim=1) / ref.norm(dim=1)).max())


@pytest.mark.parametrize("m,o,u", [(20, 512, 4096), (8, 256, 14336)])
def test_row_rms_limit_tells_a_lost_rounding_step_apart(m, o, u):
    """Against the f32-weight product in float64, each row's RMS error of
    the plain version stays within ROW_RMS_LIMIT of its RMS output, and
    the same algorithm truncating in place of rounding (one rounding step
    lost) or at half the resolution (sx doubled) exceeds it."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(m, u).astype(np.float32))
    wf = torch.from_numpy(rng.uniform(-0.07, 0.07, (o, u)).astype(
        np.float32))
    scale = i8.int8_scale(wf.abs().amax(dim=1))
    qw = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(
        torch.int8)
    ref = x.double() @ wf.double().t()
    assert _row_rms_error(i8.int8_dense_torch(x, qw, scale),
                          ref) <= ROW_RMS_LIMIT
    _, sx = i8.quantize_rows_torch(x)
    for q, step in ((torch.trunc(x / sx), sx), (torch.round(x / (2 * sx)),
                                                 2 * sx)):
        xq = torch.clamp(q, -127, 127).double()
        broken = (xq @ qw.double().t()).float() * step * scale
        assert _row_rms_error(broken, ref) > ROW_RMS_LIMIT


def test_cpu_tensors_take_the_plain_version():
    x, w, s, b = _inputs("ragged")
    out = i8.int8_dense(_t(x), _t(w), _t(s), _t(b))
    assert i8.last_path() == "torch"
    np.testing.assert_array_equal(
        out.numpy(), i8.int8_dense_torch(_t(x), _t(w), _t(s), _t(b)).numpy())
    n0 = i8.launch_count()
    i8.force_path("cuda")
    try:
        with pytest.raises(MXNetError, match="needs CUDA tensors"):
            i8.int8_dense(_t(x), _t(w), _t(s))
    finally:
        i8.force_path(None)
    assert i8.launch_count() == n0
    with pytest.raises(ValueError):
        i8.force_path("xla")


def test_quantized_dense_branch_follows_the_device(monkeypatch):
    """On CPU tensors ``ops.nn.quantized_dense`` keeps the weight-only
    branch (the JAX package's CPU branch); where ``_int8_dot`` says int8,
    it is the int8 x int8 product."""
    x, w, s, b = _inputs("batched")
    weight_only = tops.quantized_dense(_t(x), _t(w), _t(s))
    np.testing.assert_allclose(
        weight_only.numpy(), (x @ w.astype(np.float32).T) * s, rtol=1e-5,
        atol=1e-5)
    monkeypatch.setattr(tops, "_int8_dot", lambda data: True)
    np.testing.assert_array_equal(
        tops.quantized_dense(_t(x), _t(w), _t(s), _t(b)).numpy(),
        i8.int8_dense_torch(_t(x), _t(w), _t(s), _t(b)).numpy())


@pytest.mark.parametrize("m,o,u", [(1, 4096, 4096), (4, 1024, 4096),
                                   (4, 14336, 4096), (4, 4096, 14336),
                                   (4, 128256, 4096), (20, 4096, 4096),
                                   (256, 1024, 4096), (1024, 14336, 4096),
                                   (3, 37, 30)])
def test_split_plan_covers_u_without_empty_slices(m, o, u):
    plan = i8.split_plan(m, o, u, 132)
    chunks = i8.padded_u(u) // i8.CHUNK
    assert plan.block_rows == i8.block_rows_for(m)
    assert plan.block_cols == i8.TILES[plan.block_rows]
    assert plan.grid == (-(-o // plan.block_cols), -(-m // plan.block_rows),
                         plan.slices)
    assert (plan.slices - 1) * plan.chunks_per_slice < chunks
    assert plan.slices * plan.chunks_per_slice >= chunks
    tiles = plan.grid[0] * plan.grid[1]
    aim = 132 * i8.BLOCKS_PER_SM[plan.block_rows]
    if plan.slices == 1:
        assert tiles >= aim or chunks == 1
    else:
        assert plan.blocks >= aim or plan.chunks_per_slice == 1
        assert plan.workspace_bytes == plan.slices * m * o * 4


def test_int8_weights_auto_follows_the_device(monkeypatch):
    monkeypatch.delenv("MXNET_SERVE_DECODE_INT8_WEIGHTS", raising=False)
    assert tgen._int8_weights_enabled(torch.device("cuda", 0))
    assert tgen._int8_weights_enabled("cuda")
    assert not tgen._int8_weights_enabled(torch.device("cpu"))
    for flag, want in (("1", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("MXNET_SERVE_DECODE_INT8_WEIGHTS", flag)
        assert tgen._int8_weights_enabled("cpu") is want
        assert tgen._int8_weights_enabled("cuda") is (want or flag == "auto")


def test_int8_generator_on_cpu_keeps_f32_weights_under_auto(monkeypatch):
    monkeypatch.delenv("MXNET_SERVE_DECODE_INT8_WEIGHTS", raising=False)
    mx.random.seed(0)
    port = get_llama("llama_tiny_test", device="cpu")
    gen = Generator(port, decode_path="int8", max_seq=32,
                    batch_buckets=(1,), prompt_buckets=(8,))
    assert gen._qweights == {}


def test_int8_slice_matches_jax_int8_branch(monkeypatch):
    """The whole slice: ``llama_tiny_test`` served on the ``int8`` rung
    with int8 weights in both packages, each projection through its int8
    x int8 branch (the port's by a test-only patch of its branch choice,
    the JAX package's by the backend it reads). Prefill and 8 decode steps
    agree within 1e-3 of the logits' scale (measured ~1e-5: the KV rings
    requantize, and a K/V element a rounding step apart moves a logit by
    far less than that), and the greedy tokens are identical."""
    monkeypatch.setenv("MXNET_SERVE_DECODE_INT8_WEIGHTS", "1")
    monkeypatch.setattr(tops, "_int8_dot", lambda data: True)
    real = jops.quantized_dense

    def jax_int8_branch(*args, **kw):
        with _int8_matrix_unit():
            return real(*args, **kw)

    monkeypatch.setattr(jops, "quantized_dense", jax_int8_branch)
    calls = []
    kernel = i8.int8_dense

    def counted(*args, **kw):
        calls.append(1)
        return kernel(*args, **kw)

    monkeypatch.setattr(i8, "int8_dense", counted)
    mx.random.seed(0)
    net = jax_get_llama("llama_tiny_test")
    net.initialize()
    params = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    port = load_reference_params(get_llama("llama_tiny_test", device="cpu"),
                                 params)
    vocab = params["embed.weight"].shape[0]
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))
    jg = JaxGenerator(net, decode_path="int8", **kw)
    pg = Generator(port, decode_path="int8", **kw)
    assert len(pg._qweights) == 2 * 7 + 1 == len(jg._qindex)
    rng = np.random.RandomState(4)
    toks = rng.randint(1, vocab, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jl, jc = jg.prefill(toks, lens, jg._fresh_cache(2))
    pl, pc = pg.prefill(toks, lens, pg._fresh_cache(2))
    assert len(calls) == 15  # 2 layers x 7 projections + the head
    jl, pl = jl.asnumpy(), pl.numpy()
    errs = [float(np.abs(jl - pl).max())]
    scale = float(np.abs(jl).max())
    pos = lens.copy()
    for _ in range(8):
        ids = np.argmax(jl, -1).astype(np.int32)
        assert (ids == pl.argmax(-1)).all()
        jl, jc = jg.decode_step(ids, pos, jc)
        pl, pc = pg.decode_step(ids, pos, pc)
        jl, pl = jl.asnumpy(), pl.numpy()
        errs.append(float(np.abs(jl - pl).max()))
        pos = pos + 1
    assert len(calls) == 15 * 9
    assert max(errs) <= 1e-3 * scale, (errs, scale)
    prompts = [[int(t) for t in rng.randint(1, vocab, size=n)]
               for n in (7, 12)]
    jout, _ = jg.generate(prompts, max_new_tokens=8)
    pout, _ = pg.generate(prompts, max_new_tokens=8)
    assert [[int(t) for t in o] for o in jout] == pout


# -- the wgmma route for prefill rows -----------------------------------------

# Llama-3-8B's projections, (O, U): q and o, k and v, gate and up, down
LLAMA_PROJECTIONS = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]


@pytest.mark.parametrize("m", [33, 256, 1024])
@pytest.mark.parametrize("o,u", LLAMA_PROJECTIONS + [(1000, 4096), (37, 16)])
def test_wgmma_plan_depends_on_shapes_and_sm_count_alone(m, o, u):
    """The plan is a pure function of (M, O, U, SMs): recomputed from a
    cleared cache it is the same, and other SM counts give their own."""
    plans = {sms: i8.wgmma_plan(m, o, u, sms) for sms in (132, 114, 66)}
    i8.wgmma_plan.cache_clear()
    for sms, plan in plans.items():
        assert i8.wgmma_plan(m, o, u, sms) == plan
        assert plan.block_rows == i8.WGMMA_ROWS
        assert plan.block_cols in i8.WGMMA_COLS


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", [33, 130, 256, 1024, 4096])
@pytest.mark.parametrize("o,u", LLAMA_PROJECTIONS + [(1000, 4096), (37, 16),
                                                    (128256, 4096)])
def test_wgmma_plan_covers_m_o_without_empty_u_slices(m, o, u, sms):
    plan = i8.wgmma_plan(m, o, u, sms)
    chunks = -(-u // i8.WGMMA_CHUNK)
    assert plan.grid == (-(-o // plan.block_cols), -(-m // plan.block_rows),
                         plan.slices)
    assert plan.grid[0] * plan.block_cols >= o
    assert plan.grid[1] * plan.block_rows >= m
    assert (plan.slices - 1) * plan.chunks_per_slice < chunks
    assert plan.slices * plan.chunks_per_slice >= chunks
    assert plan.workspace_bytes == (plan.slices * m * o * 4
                                    if plan.slices > 1 else 0)
    tiles = plan.grid[0] * plan.grid[1]
    aim = i8.wgmma_aim(sms)
    # the wide tile where its tiles reach the aim; a split only where the
    # tiles fall short of it, with the fewest slices that reach it
    wide = -(-o // 256) * -(-m // 128)
    assert plan.block_cols == (256 if wide >= aim else 128)
    if plan.slices > 1:
        assert tiles < aim
        fewer = -(-chunks // (plan.slices - 1))  # the next longer slices
        assert tiles * -(-chunks // fewer) < aim
    assert plan.blocks >= aim or plan.chunks_per_slice == 1


@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("o,u", LLAMA_PROJECTIONS)
def test_wgmma_plan_fills_132_sms_at_llama_prefill(m, o, u):
    """Every Llama-3-8B prefill projection, at the engine's (1, 256) chunk
    and the generator's (4, 256) batch, gets blocks for half of 132 SMs at
    least, and slices of 7 chunks (896 bytes of U) or more."""
    plan = i8.wgmma_plan(m, o, u, 132)
    assert i8.wgmma_aim(132) == 66
    assert plan.blocks >= 66, plan
    assert plan.chunks_per_slice >= 7, plan


def _aligned_int8(n, offset):
    """An int8 CPU tensor of n elements starting ``offset`` bytes past a
    16-byte boundary."""
    base = torch.zeros(n + 32, dtype=torch.int8)
    skip = (-base.data_ptr()) % 16 + offset
    return base[skip:skip + n]


@pytest.mark.parametrize("m", [1, 4, 20, 32])
def test_takes_wgmma_leaves_decode_rows_to_mma_sync(m):
    for _, u in LLAMA_PROJECTIONS:
        assert not i8.takes_wgmma(m, u, _aligned_int8(64, 0).data_ptr())


@pytest.mark.parametrize("m", [33, 256, 1024])
def test_takes_wgmma_routes_ragged_and_misaligned_weights(m):
    aligned = _aligned_int8(64, 0).data_ptr()
    assert aligned % 16 == 0
    for u in (30, 4100, 4104, 14328 + 4):  # rows not a multiple of 16 bytes
        assert not i8.takes_wgmma(m, u, aligned)
    for offset in (1, 4, 8):
        ptr = _aligned_int8(64, offset).data_ptr()
        assert ptr % 16 == offset
        assert not i8.takes_wgmma(m, 4096, ptr)
    assert i8.takes_wgmma(m, 16, aligned)


@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("o,u", LLAMA_PROJECTIONS)
def test_takes_wgmma_takes_every_llama_prefill_projection(m, o, u):
    w = _aligned_int8(o * u, 0).view(o, u)
    assert i8.takes_wgmma(m, u, w.data_ptr())


def test_cpu_tensors_take_the_plain_version_at_prefill_rows(monkeypatch):
    """A CPU call of prefill rows still takes ``int8_dense_torch`` and
    counts no launch of either kernel; ``quantized_dense`` on the CPU
    keeps the weight-only branch there too."""
    rng = np.random.RandomState(11)
    x = rng.randn(64, 256).astype(np.float32)
    w = rng.randint(-127, 128, size=(48, 256)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, size=48).astype(np.float32)
    assert i8.takes_wgmma(64, 256, _t(w).data_ptr()) == (
        _t(w).data_ptr() % 16 == 0)
    routes, n0 = i8.route_launches(), i8.launch_count()
    out = i8.int8_dense(_t(x), _t(w), _t(s))
    assert i8.last_path() == "torch"
    np.testing.assert_array_equal(
        out.numpy(), i8.int8_dense_torch(_t(x), _t(w), _t(s)).numpy())
    assert i8.route_launches() == routes and i8.launch_count() == n0
    np.testing.assert_allclose(
        tops.quantized_dense(_t(x), _t(w), _t(s)).numpy(),
        (x @ w.astype(np.float32).T) * s, rtol=1e-5, atol=1e-5)


def test_reset_launch_count_zeroes_both_counts():
    i8.reset_launch_count()
    assert i8.launch_count() == 0
    assert i8.route_launches() == {"wgmma": 0, "decode": 0, "mma_sync": 0}


def test_product_refuses_a_route_that_does_not_take_the_call():
    """``product(route="wgmma")`` raises for decode rows, a ragged U or a
    misaligned weight before it touches the card; an unknown route
    raises too."""
    xq = torch.zeros(4, 64, dtype=torch.int8)
    sx = torch.ones(4)
    s = torch.ones(8)
    w = _aligned_int8(8 * 64, 0).view(8, 64)
    with pytest.raises(MXNetError, match="does not take"):
        i8.product(xq, sx, 64, w, s, route="wgmma")  # M = 4
    xq = torch.zeros(64, 64, dtype=torch.int8)
    sx = torch.ones(64)
    with pytest.raises(MXNetError, match="does not take"):
        i8.product(xq, sx, 64, _aligned_int8(8 * 64, 1).view(8, 64), s,
                   route="wgmma")
    with pytest.raises(MXNetError, match="does not take"):
        i8.product(xq, sx, 64, w, s, route="tensor_cores")


# -- the decode route: decode and verify rows on aligned weights -------------

LLAMA_DECODE_SHAPES = LLAMA_PROJECTIONS + [(128256, 4096)]  # and the head
DECODE_M = [1, 4, 17, 20, 32]


@pytest.mark.parametrize("m", DECODE_M)
def test_route_for_sends_decode_rows_to_the_decode_kernel(m):
    """Every Llama-3-8B projection and the head at decode and verify rows
    take the decode kernel on an aligned weight; ragged rows (U = 30, or
    not a multiple of 16 bytes) and a weight off a 16-byte boundary take
    ``mma_sync``."""
    for o, u in LLAMA_DECODE_SHAPES:
        w = _aligned_int8(o * 16, 0)  # only the address matters here
        assert i8.route_for(m, u, w.data_ptr()) == "decode"
        assert not i8.takes_wgmma(m, u, w.data_ptr())
    aligned = _aligned_int8(64, 0).data_ptr()
    for u in (30, 4100, 4104):
        assert i8.route_for(m, u, aligned) == "mma_sync"
    for offset in (1, 4, 8):
        ptr = _aligned_int8(64, offset).data_ptr()
        assert i8.route_for(m, 4096, ptr) == "mma_sync"


@pytest.mark.parametrize("m", [33, 256, 1024])
def test_route_for_sends_prefill_rows_to_wgmma(m):
    aligned = _aligned_int8(64, 0).data_ptr()
    for _, u in LLAMA_DECODE_SHAPES:
        assert i8.route_for(m, u, aligned) == "wgmma"
        assert i8.takes_wgmma(m, u, aligned)
    assert i8.route_for(m, 30, aligned) == "mma_sync"
    assert i8.route_for(m, 4096, _aligned_int8(64, 4).data_ptr()) == \
        "mma_sync"


@pytest.mark.parametrize("m", DECODE_M)
@pytest.mark.parametrize("o,u", LLAMA_DECODE_SHAPES + [(1000, 4096),
                                                       (37, 16), (64, 208)])
def test_decode_plan_depends_on_shapes_and_sm_count_alone(m, o, u):
    """The plan is a pure function of (M, O, U, SMs): recomputed from a
    cleared cache it is the same; its block takes every row (M rounded up
    to 8) and 64 output channels."""
    plans = {sms: i8.decode_plan(m, o, u, sms) for sms in (132, 114, 66)}
    i8.decode_plan.cache_clear()
    for sms, plan in plans.items():
        assert i8.decode_plan(m, o, u, sms) == plan
        assert plan.block_rows == 8 * -(-m // 8)
        assert plan.block_cols == i8.DECODE_COLS
        assert plan.grid[1] == 1


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", DECODE_M)
@pytest.mark.parametrize("o,u", LLAMA_DECODE_SHAPES + [(1000, 4096),
                                                       (37, 16), (64, 208)])
def test_decode_plan_covers_u_without_empty_slices(m, o, u, sms):
    """The slices cover U's 128-byte chunks with none empty, each slice's
    xq fits the kernel's budget and, where U has them, holds a whole
    stage; the workspace holds the partials of a split."""
    plan = i8.decode_plan(m, o, u, sms)
    chunks = -(-u // i8.DECODE_CHUNK)
    assert plan.grid == (-(-o // i8.DECODE_COLS), 1, plan.slices)
    assert (plan.slices - 1) * plan.chunks_per_slice < chunks
    assert plan.slices * plan.chunks_per_slice >= chunks
    assert (plan.block_rows * plan.chunks_per_slice * i8.DECODE_CHUNK
            <= max(i8.DECODE_XQ_BYTES, plan.block_rows * i8.DECODE_CHUNK))
    assert plan.chunks_per_slice >= min(chunks, i8.DECODE_MIN_CHUNKS)
    assert plan.workspace_bytes == (plan.slices * m * o * 4
                                    if plan.slices > 1 else 0)


@pytest.mark.parametrize("m", DECODE_M)
@pytest.mark.parametrize("o,u", LLAMA_DECODE_SHAPES)
def test_decode_plan_gives_every_sm_work_at_llama_decode(m, o, u):
    """At every Llama-3-8B decode and verify shape each of 132 SMs gets a
    block at least, and no SM's share of the weight is more than half
    again the mean share (the plan's blocks spread over the SMs)."""
    plan = i8.decode_plan(m, o, u, 132)
    assert plan.blocks >= 132, plan
    block_bytes = plan.chunks_per_slice * i8.DECODE_CHUNK * i8.DECODE_COLS
    fullest = -(-plan.blocks // 132) * block_bytes
    assert fullest <= 1.5 * o * u / 132 + block_bytes, plan


@pytest.mark.parametrize("m", [1, 4, 20, 256, 1024])
@pytest.mark.parametrize("u", [16, 30, 64, 4096, 14336, 70000])
def test_quantize_cluster_spreads_few_rows_and_keeps_a_row_in_registers(m, u):
    """The row quantization takes 1 to 8 blocks a row, each with at least
    64 bytes of the padded row; few rows spread over the SMs, and a row
    stays within what its blocks keep in registers wherever 8 blocks can
    hold it."""
    c = i8.quantize_cluster(m, u, 132)
    chunks = i8.padded_u(u) // i8.CHUNK
    assert c in (1, 2, 4, 8) and c <= max(1, chunks)
    keep = c * i8.QUANT_THREADS * i8.QUANT_KEEP
    if 2 * c <= chunks and c < i8.QUANT_CLUSTER_MAX:
        assert m * c >= 132 and u <= keep
    if u <= i8.QUANT_CLUSTER_MAX * i8.QUANT_THREADS * i8.QUANT_KEEP:
        assert u <= keep or 2 * c > chunks
    assert i8.quantize_cluster(m, u, 132) == c


def test_route_launches_count_decode_and_cpu_calls_count_none():
    """The route counters name the decode kernel; a CPU call of decode
    rows takes the plain version and counts no launch on any route."""
    x, w, s, b = _inputs("llama_width")
    i8.reset_launch_count()
    out = i8.int8_dense(_t(x), _t(w), _t(s), _t(b))
    assert i8.last_path() == "torch"
    np.testing.assert_array_equal(
        out.numpy(), i8.int8_dense_torch(_t(x), _t(w), _t(s), _t(b)).numpy())
    assert i8.route_launches() == dict.fromkeys(i8.ROUTES, 0)
    assert i8.launch_count() == 0
    assert set(i8.ROUTES) == {"wgmma", "decode", "mma_sync"}


def test_row_launches_reset_empty_and_cpu_calls_count_none():
    """``row_launches`` splits the eager calls by (kernel, rows M):
    ``reset_launch_count`` empties it, and CPU calls, which take the plain
    version, add no pair."""
    x, w, s, b = _inputs("llama_width")
    i8.reset_launch_count()
    assert i8.row_launches() == {}
    i8.int8_dense(_t(x), _t(w), _t(s), _t(b))
    i8.int8_dense(_t(x[:1]), _t(w), _t(s))
    assert i8.last_path() == "torch"
    assert i8.row_launches() == {}


def test_product_refuses_decode_past_32_rows_or_on_an_unreadable_weight():
    """``product(route="decode")`` raises for M > 32, a ragged U or a
    misaligned weight before it touches the card."""
    s = torch.ones(8)
    w = _aligned_int8(8 * 64, 0).view(8, 64)
    xq, sx = torch.zeros(33, 64, dtype=torch.int8), torch.ones(33)
    with pytest.raises(MXNetError, match="does not take"):
        i8.product(xq, sx, 64, w, s, route="decode")
    xq, sx = torch.zeros(4, 64, dtype=torch.int8), torch.ones(4)
    with pytest.raises(MXNetError, match="does not take"):
        i8.product(xq, sx, 64, _aligned_int8(8 * 64, 1).view(8, 64), s,
                   route="decode")
    w30 = _aligned_int8(8 * 30, 0).view(8, 30)
    with pytest.raises(MXNetError, match="does not take"):
        i8.product(xq, sx, 30, w30, s, route="decode")


@pytest.mark.parametrize("name", sorted(int8_variants.VARIANTS))
def test_int8_variants_apply_to_the_kernel_source(name):
    """Each variant that ``int8_variants`` builds applies to the kernel's
    source as it stands: every text it replaces occurs there, and every
    variant but the source itself changes it."""
    from mxnet_tpu_torch.ops.hopper._build import CSRC

    source = (CSRC / "int8_dense.cu").read_text()
    subs = int8_variants.VARIANTS[name]
    assert (int8_variants.variant_source(source, subs) == source) == (
        not subs)


def test_int8_variants_builds_only_known_variants():
    """Every variant each part of the probe builds is one of ``VARIANTS``,
    and the two parts between them build every one."""
    parts = (int8_variants.PREFILL_VARIANTS, int8_variants.DECODE_VARIANTS)
    for names in parts:
        assert set(names) <= set(int8_variants.VARIANTS), names
        assert "source" in names
    assert set().union(*parts) == set(int8_variants.VARIANTS)


def test_int8_variants_needs_cuda(capsys):
    assert int8_variants.main() == 2  # no card here: no build, no result
    assert "CUDA is not available" in capsys.readouterr().err
