"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so it
also runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's ``conftest.py`` sets up JAX.) The CPU
tests hold each plain version against the JAX package; these hold each
kernel against its plain version on the same card, at atol 1e-5 / rtol
1e-4 as ``chip_smoke.py`` does: the same f32 math, summed in another order
(the fused 1x1 pair states its own bounds, in f32 and bf16, at
``_close``).
"""
import copy

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.pallas_fuse import fuse_resnet_v1
from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
from mxnet_tpu_torch.models import get_llama
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops.hopper import conv1x1 as c1x1
from mxnet_tpu_torch.ops.hopper import decode_attention as da
from mxnet_tpu_torch.ops.hopper import flash_attention as fa
from mxnet_tpu_torch.ops.hopper import int8_dense as i8
from mxnet_tpu_torch.ops.hopper import stable_ops as st
from mxnet_tpu_torch.serve import Generator, KVCache

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-5, 1e-4
# (b, h, kv, s, d): D = 24 streams f32 as 16-byte vectors and int8 as
# scalars, D = 18 streams both as scalars, D = 128 is Llama-3-8B's head
SHAPES = [(3, 8, 2, 40, 24), (2, 6, 3, 70, 18), (2, 32, 8, 300, 128)]
LONG = (2, 32, 8, 4096, 128)  # a long ring: 128 tiles, split 8 ways


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(b, h, kv, s, d, quant, dev, seed=0):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a).to(dev)

    q = t(rng.randn(b, h, 1, d).astype(np.float32))
    if quant:
        k = t(rng.randint(-127, 128, size=(b, kv, s, d)).astype(np.int8))
        v = t(rng.randint(-127, 128, size=(b, kv, s, d)).astype(np.int8))
        ks = t(rng.uniform(1e-3, 2e-2, size=(b, kv, s)).astype(np.float32))
        vs = t(rng.uniform(1e-3, 2e-2, size=(b, kv, s)).astype(np.float32))
    else:
        k = t(rng.randn(b, kv, s, d).astype(np.float32))
        v = t(rng.randn(b, kv, s, d).astype(np.float32))
        ks = vs = None
    # mixed valid lengths: start_pos 0, one inside a partial tile, s - 1
    sp = t(np.array([0, 37, s - 1][:b] if b == 3 else [0, s - 1],
                    np.int32))
    return q, k, v, sp, ks, vs


def _int8_branch_on_cpu(monkeypatch):
    """For a card-against-CPU comparison on the ``int8`` rung: int8
    weights on both sides (``auto`` turns them on for the card only) and
    the CPU's projections through the int8 branch, whose plain version
    the card's kernel equals bit for bit."""
    monkeypatch.setenv("MXNET_SERVE_DECODE_INT8_WEIGHTS", "1")
    monkeypatch.setattr(tops, "_int8_dot", lambda data: True)


def _same_bits(a, b):
    """``a`` and ``b`` hold the same bit patterns (NaNs included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary, so the kernel must stream it with scalar loads."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_kernel_matches_plain(quant):
    """The CUDA kernel against the plain version on the card, at T == 1,
    every shape; plus the launch count and the wrapper's refusals."""
    dev = _need_cuda()
    for shape in SHAPES + [LONG]:
        q, k, v, sp, ks, vs = _inputs(*shape, quant=quant, dev=dev)
        n0 = da.launch_count()
        out = da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert da.last_path() == "cuda" and da.launch_count() == n0 + 1
        ref = da.decode_attention_torch(q, k, v, sp, k_scale=ks, v_scale=vs)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        with pytest.raises(MXNetError, match="int32"):
            da.decode_attention(q, k, v, sp.long(), k_scale=ks, v_scale=vs)
        with pytest.raises(MXNetError, match="contiguous"):
            da.decode_attention(q, k.transpose(2, 3).contiguous()
                                .transpose(2, 3), v, sp, k_scale=ks,
                                v_scale=vs)
        with pytest.raises(MXNetError, match="start_pos on cpu"):
            da.decode_attention(q, k, v, sp.cpu(), k_scale=ks, v_scale=vs)
        # a row with no position (start_pos < 0) emits zeros: the l == 0
        # rule of the Pallas kernel
        sp_dead = sp.clone()
        sp_dead[0] = -1
        out = da.decode_attention(q, k, v, sp_dead, k_scale=ks, v_scale=vs)
        assert not bool(out[0].any())
        assert da.launch_count() == n0 + 2


def test_cuda_kernel_scalar_loads_on_misaligned_rings():
    """f32 rings that are not 16-byte aligned take the scalar-load
    instantiation and give the same answer."""
    dev = _need_cuda()
    q, k, v, sp, _, _ = _inputs(*SHAPES[-1], quant=False, dev=dev)
    km, vm = _misaligned(k), _misaligned(v)
    assert km.data_ptr() % 16 and km.is_contiguous()
    out = da.decode_attention(q, km, vm, sp)
    ref = da.decode_attention_torch(q, k, v, sp)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_kernel_forced_splits(quant):
    """Every split count, from one (the block writes out) to more splits
    than the ring has tiles, against the plain version and the plain mirror
    of the split; rows so short that most splits lie past start_pos, and a
    dead row (start_pos -1), which gives zeros. G = 8 and G = 2 take two
    and one half-empty head groups a block."""
    dev = _need_cuda()
    for shape, sps in (((3, 8, 2, 300, 128), [-1, 5, 299]),
                       ((2, 16, 2, 100, 24), [40, 99]),
                       ((2, 6, 3, 70, 18), [0, 33])):
        q, k, v, _, ks, vs = _inputs(*shape, quant=quant, dev=dev)
        sp = torch.tensor(sps, dtype=torch.int32, device=dev)
        live = sp >= 0
        ref = da.decode_attention_torch(q, k, v, sp, k_scale=ks, v_scale=vs)
        for n_split in (1, 2, 3, 5, 16, 40):
            n0 = da.launch_count()
            out = da._launch(q, k, v, sp, shape[-1] ** -0.5, ks, vs,
                             n_split=n_split)
            torch.cuda.synchronize()
            assert da.launch_count() == n0 + 1
            torch.testing.assert_close(out[live], ref[live], atol=ATOL,
                                       rtol=RTOL)
            assert not bool(out[~live].any())
            mirror = da.decode_attention_split_torch(
                q, k, v, sp, n_split, k_scale=ks, v_scale=vs)
            torch.testing.assert_close(out, mirror, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_kernel_repeats_bitwise(quant):
    """The partials merge in split order, with no atomics: two calls give
    bitwise equal outputs, split or not."""
    dev = _need_cuda()
    for shape in (SHAPES[-1], LONG):
        q, k, v, sp, ks, vs = _inputs(*shape, quant=quant, dev=dev)
        for n_split in (None, 1):
            a = da._launch(q, k, v, sp, shape[-1] ** -0.5, ks, vs, n_split)
            b = da._launch(q, k, v, sp, shape[-1] ** -0.5, ks, vs, n_split)
            assert torch.equal(a, b)


def test_cuda_kernel_makes_no_host_sync():
    """The plan comes from shapes alone: a call never waits for the device
    (start_pos is not read on the host)."""
    dev = _need_cuda()
    for quant in (False, True):
        q, k, v, sp, ks, vs = _inputs(*SHAPES[-1], quant=quant, dev=dev)
        da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)  # build
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert da.last_path() == "cuda"
        torch.testing.assert_close(out, da.decode_attention_torch(
            q, k, v, sp, k_scale=ks, v_scale=vs), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_kernel_replays_in_a_cuda_graph(quant):
    """One call (split kernel and combine) captured in a CUDA graph and
    replayed after start_pos changes in place matches the plain version at
    each position: the contract multi-step decode needs."""
    dev = _need_cuda()
    shape = SHAPES[-1]
    q, k, v, _, ks, vs = _inputs(*shape, quant=quant, dev=dev)
    sp = torch.tensor([3, 140], dtype=torch.int32, device=dev)
    assert da.split_plan(2, 8, 300, 4, 128, torch.cuda.get_device_properties(
        dev).multi_processor_count).splits > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)  # warm
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0, c0 = da.launch_count(), da.captured_count()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, sp, k_scale=ks, v_scale=vs)
    # a capture records the launch; the card runs it at each replay
    assert da.captured_count() == c0 + 1 and da.launch_count() == n0
    for sps in ([3, 140], [-1, 299], [64, 65], [200, 0]):
        sp.copy_(torch.tensor(sps, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = da.decode_attention_torch(q, k, v, sp, k_scale=ks, v_scale=vs)
        live = sp >= 0
        torch.testing.assert_close(out[live], ref[live], atol=ATOL,
                                   rtol=RTOL)
        assert not bool(out[~live].any())


def test_cuda_kernel_launch_errors_raise(monkeypatch):
    """A launch the runtime refuses, of the split kernel or of the combine
    after it, surfaces as MXNetError naming the plan and is not counted."""
    dev = _need_cuda()
    q, k, v, sp, _, _ = _inputs(*SHAPES[-1], quant=False, dev=dev)
    lib = da._lib()
    n0 = da.launch_count()
    for entry, what in (("mxtt_decode_attention", "decode_attention kernel"),
                        ("mxtt_decode_attention_combine",
                         "decode_attention combine kernel")):
        class Refusing:
            def __getattr__(self, name):
                if name == entry:
                    return lambda *args: 1  # cudaErrorInvalidValue
                return getattr(lib, name)

        monkeypatch.setattr(da, "_LIB", Refusing())
        with pytest.raises(MXNetError, match=f"{what} launch failed: invalid "
                           "argument .*plan SplitPlan"):
            da.decode_attention(q, k, v, sp)
        assert da.launch_count() == n0
    monkeypatch.setattr(da, "_LIB", lib)
    with pytest.raises(MXNetError, match="invalid argument"):
        da._launch(q, k, v, sp, 0.1, None, None, n_split=0)
    assert da.launch_count() == n0


def test_cuda_wrapper_routing_and_refusals():
    dev = _need_cuda()
    q, k, v, sp, _, _ = _inputs(*SHAPES[0], quant=False, dev=dev)
    n0 = da.launch_count()
    # T > 1 (prefill) takes the plain version, as the JAX package routes it
    q5 = q.expand(-1, -1, 5, -1).contiguous()
    out = da.decode_attention(q5, k, v, sp)
    assert da.last_path() == "torch" and da.launch_count() == n0
    torch.testing.assert_close(out, da.decode_attention_torch(q5, k, v, sp))
    da.force_path("cuda")
    try:
        with pytest.raises(MXNetError, match="T must be 1"):
            da.decode_attention(q5, k, v, sp)
    finally:
        da.force_path(None)
    da.force_path("torch")
    try:
        da.decode_attention(q, k, v, sp)
        assert da.last_path() == "torch" and da.launch_count() == n0
    finally:
        da.force_path(None)
    with pytest.raises(MXNetError, match="float32"):
        da.decode_attention(q.double(), k, v, sp)
    with pytest.raises(MXNetError, match="head_dim"):
        z = torch.zeros(1, 2, 1, 264, device=dev)
        da.decode_attention(z, torch.zeros(1, 1, 8, 264, device=dev),
                            torch.zeros(1, 1, 8, 264, device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev))
    with pytest.raises(MXNetError, match="multiple"):
        da.decode_attention(q[:, :3].contiguous(), k, v, sp)
    assert da.launch_count() == n0


@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_cuda_generator_matches_cpu(rung, monkeypatch):
    """``Generator`` on the card, every decode step through the kernel,
    against the same weights served on the CPU through the plain version:
    prefill and decode logits within the bounds of the JAX comparison in
    ``test_torch_llama.py`` (1e-4 on ``pallas``, where only the order of
    f32 sums differs; 1e-2 on ``int8``, where a K/V element or an
    activation a rounding step apart quantizes one int8 step apart),
    identical greedy tokens, and one launch per layer per decode step. On
    ``int8`` both sides run int8 weights through the int8 branch: 15 int8
    products a forward on the card (2 layers x 7 and the head)."""
    _int8_branch_on_cpu(monkeypatch)
    dev = _need_cuda()
    trandom.seed(0)
    cpu_model = get_llama("llama_tiny_test", device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,),
              decode_path=rung)
    cg, gg = Generator(cpu_model, **kw), Generator(gpu_model, **kw)
    gg.warmup()
    rng = np.random.RandomState(1)
    toks = rng.randint(1, 256, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    cl, cc = cg.prefill(toks, lens, cg._fresh_cache(2))
    gl, gc = gg.prefill(toks, lens, gg._fresh_cache(2))
    errs = [float((cl - gl.cpu()).abs().max())]
    pos = lens.copy()
    n0, q0 = da.launch_count(), i8.launch_count()
    for step in range(8):
        ids = rng.randint(1, 256, size=2).astype(np.int32)
        cl, cc = cg.decode_step(ids, pos, cc)
        gl, gc = gg.decode_step(ids, pos, gc)
        errs.append(float((cl - gl.cpu()).abs().max()))
        pos = pos + 1
    assert da.launch_count() == n0 + 8 * 2  # 8 steps x 2 layers
    assert i8.launch_count() - q0 == (8 * 15 if rung == "int8" else 0)
    assert max(errs) <= {"pallas": 1e-4, "int8": 1e-2}[rung], errs

    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7]]
    n0 = da.launch_count()
    gout, info = gg.generate(prompts, max_new_tokens=12)
    assert da.launch_count() == n0 + 2 * info["decode_steps"]
    cout, _ = cg.generate(prompts, max_new_tokens=12)
    assert gout == cout
    gg.assert_no_recompiles()


def test_cuda_kv_cache_write_q_matches_cpu():
    """Quantize-on-write on the card gives the CPU's int8 values and
    scales (both round half to even)."""
    dev = _need_cuda()
    rng = np.random.RandomState(2)
    new = torch.from_numpy((rng.randn(2, 8, 3, 128) * 3).astype(np.float32))
    sp = torch.tensor([0, 61], dtype=torch.int32)
    rings = [(torch.zeros(2, 8, 64, 128, dtype=torch.int8),
              torch.zeros(2, 8, 64)) for _ in range(2)]
    cq, cs = tops.kv_cache_write_q(*rings[0], new, sp)
    gq, gs = tops.kv_cache_write_q(rings[1][0].to(dev), rings[1][1].to(dev),
                                   new.to(dev), sp.to(dev))
    assert torch.equal(gq.cpu(), cq)
    assert torch.equal(gs.cpu(), cs)


# (b, h, tq, tk, d, causal, valid_length): dead rows (valid length 0, and
# Tq > Tk under the causal offset), ragged T, the three tile configurations;
# T = 333 spans three 128-row resident tiles and eleven 32-row streamed
# tiles of each backward kernel, the last ones ragged, at D = 128, at D = 30
# (not a multiple of 4: the backward kernels' 4-byte copies) and at D = 256
# (32-row resident tiles)
FLASH_CASES = [
    (2, 4, 128, 128, 64, True, None),
    (2, 3, 100, 100, 16, False, [0, 60]),
    (1, 2, 70, 130, 128, True, None),
    (1, 2, 130, 70, 128, True, None),
    (2, 2, 1000, 1000, 128, True, [1000, 999]),
    (1, 2, 257, 257, 200, True, [200]),
    (2, 2, 333, 333, 128, True, None),
    (2, 2, 333, 333, 30, True, [333, 150]),
    (2, 2, 333, 333, 256, True, [333, 290]),
]


def _flash_inputs(b, h, tq, tk, d, vl, dev, seed=0):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    q, k, v, g = t(b * h, tq, d), t(b * h, tk, d), t(b * h, tk, d), \
        t(b * h, tq, d)
    kvalid = fa.kvalid_of(None if vl is None else torch.tensor(vl), b, tk,
                          dev)
    return q, k, v, g, kvalid


@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_kernels_match_plain(case):
    """Each flash kernel against its plain version on the card; dead rows
    give exact zeros and lse = -1e30; one launch counted per call."""
    dev = _need_cuda()
    b, h, tq, tk, d, causal, vl = case
    q, k, v, g, kvalid = _flash_inputs(b, h, tq, tk, d, vl, dev)
    args = (kvalid, causal, tk - tq, d ** -0.5)
    n0 = fa.launch_count()
    out, lse = fa.flash_fwd(q, k, v, *args)
    ref_out, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
    delta = (g * ref_out).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args)
    torch.cuda.synchronize()
    assert fa.last_path() == "cuda"
    assert fa.launch_count() == {n: n0[n] + 1 for n in fa.KERNELS}
    ref_dq = fa.flash_bwd_dq_torch(q, k, v, g, ref_lse, delta, *args)
    ref_dk, ref_dv = fa.flash_bwd_dkv_torch(q, k, v, g, ref_lse, delta,
                                            *args)
    for ours, ref in ((out, ref_out), (lse, ref_lse), (dq, ref_dq),
                      (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(ours, ref, atol=ATOL, rtol=RTOL)
    dead = ref_lse <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    assert not out[dead].any() and not dq[dead].any()
    if vl is not None and vl[0] == 0:
        assert bool(dead[:h].all()) and not dk[:h].any() and not dv[:h].any()


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (1, 4, 7, 8)])
def test_cuda_flash_backward_repeats_bitwise(case):
    """Each backward kernel launched twice on the same inputs gives bitwise
    equal outputs: no atomics, every sum in a fixed order."""
    dev = _need_cuda()
    b, h, tq, tk, d, causal, vl = case
    q, k, v, g, kvalid = _flash_inputs(b, h, tq, tk, d, vl, dev, seed=3)
    args = (kvalid, causal, tk - tq, d ** -0.5)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = (g * out).sum(-1)
    first = [fa.flash_bwd_dq(q, k, v, g, lse, delta, *args),
             *fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)]
    again = [fa.flash_bwd_dq(q, k, v, g, lse, delta, *args),
             *fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)]
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (1, 4, 7, 8)])
def test_cuda_flash_forward_repeats_bitwise(case):
    """The forward kernel launched twice on the same inputs gives bitwise
    equal out and lse: no atomics, every sum in a fixed order."""
    dev = _need_cuda()
    b, h, tq, tk, d, causal, vl = case
    q, k, v, _, kvalid = _flash_inputs(b, h, tq, tk, d, vl, dev, seed=4)
    args = (kvalid, causal, tk - tq, d ** -0.5)
    out, lse = fa.flash_fwd(q, k, v, *args)
    out2, lse2 = fa.flash_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    assert fa.last_path() == "cuda"
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_cuda_flash_attention_autograd_matches_cpu():
    """``attention`` on CUDA tensors (``_FlashCore`` on the three kernels)
    against the plain attention on the CPU, forward and gradients."""
    dev = _need_cuda()
    rng = np.random.RandomState(1)
    arrays = [rng.randn(2, 4, 200, 64).astype(np.float32) for _ in range(4)]
    vl = torch.tensor([200, 77], dtype=torch.int32)
    cpu = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    gpu = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays[:3]]
    n0 = fa.launch_count()
    out = fa.attention(*gpu, causal=True, valid_length=vl.to(dev))
    assert fa.last_path() == "cuda"
    grads = torch.autograd.grad(out, gpu, torch.from_numpy(arrays[3]).to(dev))
    assert fa.launch_count() == {n: n0[n] + 1 for n in fa.KERNELS}
    ref = fa.attention_torch(*cpu, causal=True, valid_length=vl)
    ref_grads = torch.autograd.grad(ref, cpu, torch.from_numpy(arrays[3]))
    torch.testing.assert_close(out.cpu(), ref, atol=ATOL, rtol=RTOL)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a.cpu(), b, atol=ATOL, rtol=RTOL)


def test_cuda_flash_refusals_and_forced_plain():
    dev = _need_cuda()
    q, k, v, g, kvalid = _flash_inputs(1, 2, 64, 64, 32, None, dev)
    n0 = fa.launch_count()
    with pytest.raises(MXNetError, match="int32"):
        fa.flash_fwd(q, k, v, kvalid.long(), True, 0, 0.1)
    with pytest.raises(MXNetError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     kvalid, True, 0, 0.1)
    with pytest.raises(MXNetError, match="kvalid on cpu"):
        fa.flash_fwd(q, k, v, kvalid.cpu(), True, 0, 0.1)
    with pytest.raises(MXNetError, match="float32"):
        fa.flash_fwd(q.double(), k.double(), v.double(), kvalid, True, 0,
                     0.1)
    with pytest.raises(MXNetError, match="head_dim"):
        z = torch.zeros(1, 1, 4, 264, device=dev)
        fa.attention(z, z, z)
    fa.force_path("torch")
    try:
        fa.attention(q[None], k[None], v[None], causal=True)
        assert fa.last_path() == "torch"
    finally:
        fa.force_path(None)
    assert fa.launch_count() == n0



def test_cuda_flash_force_path_versions():
    """``force_path("versions")`` on CUDA tensors: the autograd function on
    the kernels' plain versions, launching nothing, equal to those plain
    versions called directly."""
    dev = _need_cuda()
    q, k, v, g, kvalid = _flash_inputs(2, 2, 64, 64, 32, [64, 0], dev)
    n0 = fa.launch_count()
    qs, ks, vs = (x.view(2, 2, 64, 32).clone().requires_grad_()
                  for x in (q, k, v))
    fa.force_path("versions")
    try:
        out = fa.attention(qs, ks, vs, causal=True, valid_length=kvalid)
        assert fa.last_path() == "torch"
        grads = torch.autograd.grad(out, (qs, ks, vs), g.view(out.shape))
    finally:
        fa.force_path(None)
    assert fa.launch_count() == n0
    args = (kvalid, True, 0, fa._scale_of(None, 32))
    ref, lse = fa.flash_fwd_torch(q, k, v, *args)
    delta = (g * ref).sum(-1)
    refs = [ref, fa.flash_bwd_dq_torch(q, k, v, g, lse, delta, *args),
            *fa.flash_bwd_dkv_torch(q, k, v, g, lse, delta, *args)]
    for a, b in zip([out, *grads], refs):
        assert a.is_cuda and torch.equal(a.reshape(b.shape), b)

def test_cuda_trainer_matches_cpu():
    """Three SGD steps of ``llama_tiny_test`` on the card (every layer's
    attention through the flash kernels) against the same steps on the
    CPU: losses and parameters to 1e-5."""
    dev = _need_cuda()
    trandom.seed(0)
    cpu_model = get_llama("llama_tiny_test", device="cpu", trainable=True)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, size=(2, 129)))
    results = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        tr = Trainer(model.parameters(), "sgd", {"learning_rate": 0.1,
                                                 "momentum": 0.9})
        x, y = toks[:, :-1].to(d), toks[:, 1:].to(d)
        losses = []
        n0 = fa.launch_count()
        for _ in range(3):
            loss = tloss.SoftmaxCrossEntropyLoss()(model(x), y)
            loss.sum().backward()
            tr.step(2)
            losses.append(loss.detach().cpu())
        launched = {n: fa.launch_count()[n] - n0[n] for n in fa.KERNELS}
        results.append((losses, launched))
    (cpu_losses, cpu_launched), (gpu_losses, gpu_launched) = results
    assert cpu_launched == dict.fromkeys(fa.KERNELS, 0)
    assert gpu_launched == dict.fromkeys(fa.KERNELS, 2 * 3)  # layers x steps
    for a, b in zip(gpu_losses, cpu_losses):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for (name, a), b in zip(gpu_model.named_parameters(),
                            cpu_model.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-5,
                                   rtol=0, msg=name)


# the flash kernels' other dtype pairs: (q/k, v)
FLASH_PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float16),
               (torch.bfloat16, torch.bfloat16),
               (torch.float16, torch.float16)]
_MANT = {torch.bfloat16: 7, torch.float16: 10}


def _dtype_close(ours, ref):
    """Within ATOL / RTOL plus one unit in the last place of the output's
    dtype at the larger value: kernel and plain version compute in f32 and
    round once to it."""
    assert ours.dtype == ref.dtype
    a, r = ours.float(), ref.float()
    bound = ATOL + RTOL * r.abs()
    if ours.dtype in _MANT:
        lo = -14 if ours.dtype == torch.float16 else -126
        _, e = torch.frexp(torch.maximum(a.abs(), r.abs()))
        bound = bound + torch.ldexp(torch.ones_like(a), torch.clamp(
            e - 1, min=lo) - _MANT[ours.dtype])
    diff = (a - r).abs()
    assert bool((diff <= bound).all()), float(diff.max())


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (1, 4, 7, 8)])
@pytest.mark.parametrize("pair", FLASH_PAIRS,
                         ids=["f32-bf16", "f32-f16", "bf16", "f16"])
def test_cuda_flash_dtype_pairs_match_plain(pair, case):
    """Each flash kernel's (q/k, v) instantiation against its plain version
    on the card, with ragged T, valid lengths and dead rows: out and dq in
    q's dtype, dk in k's, dv in v's; launches counted on that pair."""
    dev = _need_cuda()
    b, h, tq, tk, d, causal, vl = case
    qk, vt = pair
    q, k, v, g, kvalid = _flash_inputs(b, h, tq, tk, d, vl, dev, seed=5)
    q, k, g, v = q.to(qk), k.to(qk), g.to(qk), v.to(vt)
    args = (kvalid, causal, tk - tq, d ** -0.5)
    n0 = fa.launch_count(pair)
    out, lse = fa.flash_fwd(q, k, v, *args)
    ref_out, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
    delta = (g.float() * ref_out.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, g, ref_lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, ref_lse, delta, *args)
    torch.cuda.synchronize()
    assert fa.last_path() == "cuda"
    assert fa.launch_count(pair) == {n: n0[n] + 1 for n in fa.KERNELS}
    ref_dq = fa.flash_bwd_dq_torch(q, k, v, g, ref_lse, delta, *args)
    ref_dk, ref_dv = fa.flash_bwd_dkv_torch(q, k, v, g, ref_lse, delta,
                                            *args)
    assert (out.dtype, dq.dtype, dk.dtype, dv.dtype) == (qk, qk, qk, vt)
    for ours, ref in ((out, ref_out), (lse, ref_lse), (dq, ref_dq),
                      (dk, ref_dk), (dv, ref_dv)):
        _dtype_close(ours, ref)
    dead = ref_lse <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    assert not out[dead].any() and not dq[dead].any()
    if vl is not None and vl[0] == 0:
        assert not dk[:h].any() and not dv[:h].any()


def test_cuda_flash_bad_dtype_pair_raises():
    """A pair with no instantiation, or k of another dtype than q, raises
    before any launch; nothing is cast or routed to the plain version."""
    dev = _need_cuda()
    q, k, v, g, kvalid = _flash_inputs(1, 2, 64, 64, 32, None, dev)
    n0 = fa.launch_count()
    for qd, kd, vd in ((torch.bfloat16, torch.bfloat16, torch.float32),
                       (torch.float16, torch.float16, torch.bfloat16),
                       (torch.float32, torch.bfloat16, torch.bfloat16)):
        with pytest.raises(MXNetError, match="no instantiation"):
            fa.flash_fwd(q.to(qd), k.to(kd), v.to(vd), kvalid, True, 0, 0.1)
        with pytest.raises(MXNetError, match="no instantiation"):
            fa.attention(q[None].to(qd), k[None].to(kd), v[None].to(vd),
                         causal=True)
    assert fa.launch_count() == n0


# the (bf16, bf16) backward kernels, written for bf16 mma.sync: BERT-base's
# attention shape with its key lengths (112 on every fourth row, else 128)
# and one row of length 0; D = 30 (narrow copies) and D = 256 (two warps a
# row group, 32-key tiles); D = 64 from inputs 2 bytes off 16-byte
# alignment (narrow copies at a full row width)
BF16 = (torch.bfloat16, torch.bfloat16)
BERT_VL = [112 if i % 4 == 0 else 128 for i in range(64)]
BERT_VL[1] = 0
BF16_BWD_CASES = [(64, 12, 128, 128, 64, False, BERT_VL, False),
                  (2, 2, 333, 333, 30, True, [333, 150], False),
                  (2, 2, 333, 333, 256, True, [333, 0], False),
                  (2, 3, 200, 200, 64, False, [200, 77], True)]


@pytest.mark.parametrize("case", BF16_BWD_CASES,
                         ids=["bert", "d30", "d256", "misaligned"])
def test_cuda_flash_bf16_backward_matches_plain(case):
    """The (bf16, bf16) dq and dk/dv kernels against their plain versions
    (within ATOL / RTOL plus one bf16 unit in the last place), launches
    counted on the pair; the rows of length 0 and the keys past each valid
    length exact zeros; two calls bit for bit."""
    dev = _need_cuda()
    b, h, tq, tk, d, causal, vl, misaligned = case
    q, k, v, g, kvalid = _flash_inputs(b, h, tq, tk, d, vl, dev, seed=7)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    args = (kvalid, causal, tk - tq, d ** -0.5)
    out, lse = fa.flash_fwd_torch(q, k, v, *args)
    delta = (g.float() * out.float()).sum(-1)
    if misaligned:
        q, k, v, g = (_misaligned(x) for x in (q, k, v, g))
    n0 = fa.launch_count(BF16)
    runs = [[fa.flash_bwd_dq(q, k, v, g, lse, delta, *args),
             *fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)]
            for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.last_path() == "cuda"
    counted = fa.launch_count(BF16)
    assert (counted["bwd_dq"], counted["bwd_dkv"]) == (n0["bwd_dq"] + 2,
                                                     n0["bwd_dkv"] + 2)
    refs = [fa.flash_bwd_dq_torch(q, k, v, g, lse, delta, *args),
            *fa.flash_bwd_dkv_torch(q, k, v, g, lse, delta, *args)]
    for ours, again, ref in zip(runs[0], runs[1], refs):
        _dtype_close(ours, ref)
        assert torch.equal(ours, again)
    dq, dk, dv = runs[0]
    dead = lse <= -1e29
    cut = (torch.arange(tk, device=dev)[None, :]
           >= kvalid.repeat_interleave(h)[:, None])
    assert bool(cut.any()) and bool(dead.any()) == (0 in vl)
    assert not dq[dead].any() and not dk[cut].any() and not dv[cut].any()


# the (bf16, bf16) forward, written for bf16 mma.sync: the backward's cases
# and a causal grid with Tq < Tk at D = 128
BF16_FWD_CASES = BF16_BWD_CASES + [(2, 2, 100, 300, 128, True, None, False)]


@pytest.mark.parametrize("case", BF16_FWD_CASES,
                         ids=["bert", "d30", "d256", "misaligned",
                              "causal-tq<tk-d128"])
def test_cuda_flash_bf16_forward_matches_plain(case):
    """The (bf16, bf16) forward kernel against its plain version: out
    within ATOL / RTOL plus one bf16 unit in the last place, lse within the
    f32 tolerance; launches counted on the pair; a row with no kept key
    gives exact zeros and lse = -1e30; two calls bit for bit."""
    dev = _need_cuda()
    b, h, tq, tk, d, causal, vl, misaligned = case
    q, k, v, _, kvalid = _flash_inputs(b, h, tq, tk, d, vl, dev, seed=8)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    if misaligned:
        q, k, v = (_misaligned(x) for x in (q, k, v))
    args = (kvalid, causal, tk - tq, d ** -0.5)
    n0 = fa.launch_count(BF16)
    runs = [fa.flash_fwd(q, k, v, *args) for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.last_path() == "cuda"
    assert fa.launch_count(BF16)["fwd"] == n0["fwd"] + 2
    ref_out, ref_lse = fa.flash_fwd_torch(q, k, v, *args)
    (out, lse), (out2, lse2) = runs
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _dtype_close(out, ref_out)
    _dtype_close(lse, ref_lse)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    dead = ref_lse <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    assert bool((lse[dead] == -1e30).all()) and not out[dead].any()
    if vl is not None and 0 in vl:
        assert bool(dead.any())


def test_cuda_flash_bf16_backward_kernel_attributes():
    """The (bf16, bf16) forward, dq and dk/dv kernels: four warps a block
    and at least two blocks an SM (the forward four at D = 64 with 16-byte
    copies, three with narrow ones, which spilled 8 bytes at four, and
    three at D = 128; dq three at D <= 128, dk/dv three at D = 64). dk/dv
    spills nothing, nor do the forward and dq at D = 64, BERT-base's head. dq at
    D = 128 holds three blocks at the 168 registers they leave a thread
    and spills a few registers (24 bytes with 16-byte copies, 32 without,
    on an H100 with CUDA 12.8): two blocks at 255 registers spill nothing
    but ran 20% slower at the Llama training shape. The forward at D = 128
    spills a few bytes at three blocks too (8 with 16-byte copies): two
    blocks spill nothing but ran 9% slower there. At D = 256 (two blocks,
    255 registers) dq spills 40 bytes. Every other pair keeps its one
    block of eight warps an SM."""
    _need_cuda()
    for d in (64, 128, 256):
        for vec in (True, False):
            got = fa.kernel_attributes(BF16, d, vec)
            for name, blocks in (("fwd", 4 if d <= 64 and vec else 3
                                  if d <= 128 else 2),
                                 ("bwd_dq", 3 if d <= 128 else 2),
                                 ("bwd_dkv", 3 if d <= 64 else 2)):
                at = got[name]
                spill = 64 if name != "bwd_dkv" and d > 64 else 0
                assert at["local_bytes"] <= spill, (d, vec, name, at)
                assert at["threads"] == 128, (d, vec, name, at)
                assert at["blocks_per_sm"] >= blocks, (d, vec, name, at)
    for pair in FLASH_PAIRS[:2]:
        at = fa.kernel_attributes(pair, 128)
        assert all(a["threads"] == 256 and a["blocks_per_sm"] == 1
                   for a in at.values()), (pair, at)


def test_cuda_sharded_bf16_step_matches_cpu():
    """Three ``ShardedTrainer(dtype="bfloat16")`` steps of
    ``llama_tiny_test`` with recompute on the card against the same steps
    on the CPU. The bf16 products round in other places on the two
    devices, so losses are held to 1e-4 and the weights to 8e-3 of how far
    they moved, in norm (``tests/test_torch_sharded.py``'s measure).
    Launches: layer 0's attention takes (f32, f32, bf16), the other layer's
    f32, the forward twice a step (the recompute)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer

    dev = _need_cuda()
    trandom.seed(0)
    cpu_model = get_llama("llama_tiny_test", device="cpu", trainable=True,
                          remat=True)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    init = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, size=(2, 129)))
    results = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        tr = ShardedTrainer(model, tloss.SoftmaxCrossEntropyLoss(), "adam",
                            {"learning_rate": 1e-3}, dtype="bfloat16")
        x, y = toks[:, :-1].to(d), toks[:, 1:].to(d)
        n0 = {p: fa.launch_count(p) for p in fa.DTYPE_PAIRS}
        losses = [float(tr.step(x, y)) for _ in range(3)]
        launched = {fa.pair_label(p): {n: fa.launch_count(p)[n] - n0[p][n]
                                       for n in fa.KERNELS}
                    for p in fa.DTYPE_PAIRS[:2]}
        results.append((losses, launched))
    (cpu_losses, cpu_launched), (gpu_losses, gpu_launched) = results
    zero = dict.fromkeys(fa.KERNELS, 0)
    assert cpu_launched == {"f32": zero, "f32_bf16": zero}
    per_layer = {"fwd": 2 * 3, "bwd_dq": 3, "bwd_dkv": 3}
    assert gpu_launched == {"f32": per_layer, "f32_bf16": per_layer}
    assert gpu_losses[2] < gpu_losses[0]
    np.testing.assert_allclose(gpu_losses, cpu_losses, atol=1e-4, rtol=0)
    diff = moved = 0.0
    for (name, a), b in zip(gpu_model.named_parameters(),
                            cpu_model.parameters()):
        diff += float(((a.detach().cpu() - b.detach()).double() ** 2).sum())
        moved += float(((b.detach() - init[name]).double() ** 2).sum())
    assert (diff / moved) ** 0.5 <= 8e-3


def test_cuda_loss_scaler_overflow_skips_update():
    """On the card: an inf gradient skips the update (weights bit for bit),
    halves the scale and drops the gradients; the next clean step folds
    the unscale in and matches the same step on the CPU."""
    from mxnet_tpu_torch import amp

    dev = _need_cuda()
    torch.manual_seed(3)
    cpu = torch.nn.Linear(8, 4)
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(5, 8).astype(np.float32))
    steps = []
    for lin, d in ((cpu, "cpu"), (gpu, dev)):
        tr = Trainer(lin.parameters(), "sgd", {"learning_rate": 0.1},
                     loss_scaler=amp.LossScaler(init_scale=2.0 ** 10))
        tr.scale_loss(lin(x.to(d)).square().sum()).backward()
        lin.weight.grad[0, 0] = float("inf")
        before = [p.detach().clone() for p in lin.parameters()]
        tr.step(5)
        assert all(torch.equal(a, b) for a, b in zip(lin.parameters(),
                                                      before))
        assert lin.weight.grad is None and tr.loss_scaler.loss_scale == 512.0
        tr.scale_loss(lin(x.to(d)).square().sum()).backward()
        tr.step(5)
        steps.append([p.detach().cpu() for p in lin.parameters()])
    for a, b in zip(*steps):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# (lead, c1, cm, cout, residual, return_mid): the ResNet-50 boundary at
# stage 1 and 4 widths on a few rows, a ragged M, cout != c1, Cout above
# one block's 512 columns (a second grid dimension), channel counts that
# are no multiple of 16 bytes (scalar loads); then Cm split across blocks
# with a ragged last slice (5 x 192 and 40 columns on 132 SMs), split with
# scalar loads, stage 3 at batch 1 (S = 16), and an x tile too wide to stay
# in shared memory (x streams with w1)
PAIR_CASES = [
    ((2, 9, 9), 64, 256, 64, True, True),
    ((1, 7, 7), 512, 2048, 512, True, True),
    ((33,), 256, 128, 192, False, False),
    ((100,), 128, 512, 128, True, False),
    ((70,), 96, 160, 600, True, True),
    ((45,), 20, 36, 12, True, True),
    ((4000,), 256, 1000, 256, True, True),
    ((50,), 22, 300, 14, True, True),
    ((1, 14, 14), 256, 1024, 256, True, True),
    ((40,), 1024, 128, 64, True, False),
]


def _pair_inputs(lead, c1, cm, cout, residual, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.randn(*shape) * scale + shift
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(*lead, c1, scale=0.5).to(dtype)
    w1 = t(c1, cm, scale=(2.0 / c1) ** 0.5).to(dtype)
    w2 = t(cm, cout, scale=(2.0 / cm) ** 0.5).to(dtype)
    aff = [t(cm, scale=0.2, shift=1.0), t(cm, scale=0.1),
           t(cout, scale=0.2, shift=1.0), t(cout, scale=0.1)]
    res = t(*lead, cm, scale=0.5).to(dtype) if residual else None
    return x, w1, w2, aff, res


def _close(ours, ref, dtype):
    """f32: atol/rtol 1e-4 (the same f32 sums in another order). bf16:
    within 2e-2 of the plain version's largest value (an h a rounding step
    apart in bf16 moves y by about one bf16 ulp of h times w2)."""
    if dtype == torch.float32:
        torch.testing.assert_close(ours, ref, atol=1e-4, rtol=1e-4)
    else:
        diff = float((ours.float() - ref.float()).abs().max())
        assert diff <= 2e-2 * float(ref.float().abs().max()), diff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PAIR_CASES)
def test_cuda_conv1x1_pair_matches_plain(case, dtype):
    """The fused 1x1-pair kernel against its plain version on the card, in
    each variant it takes; one launch counted per call, by variant."""
    dev = _need_cuda()
    lead, c1, cm, cout, residual, return_mid = case
    x, w1, w2, aff, res = _pair_inputs(lead, c1, cm, cout, residual, dtype,
                                       dev)
    n0 = c1x1.launch_count()
    got = c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res,
                            return_mid=return_mid)
    torch.cuda.synchronize()
    assert c1x1.last_path() == "cuda"
    variant = ("pair_res_mid" if return_mid else
               "pair_res" if residual else "pair")
    n1 = c1x1.launch_count()
    assert {k: n1[k] - n0[k] for k in c1x1.KERNELS} == {
        k: int(k == variant) for k in c1x1.KERNELS}
    ref = c1x1.conv1x1_pair_torch(x, w1, w2, *aff, residual=res,
                                  return_mid=return_mid)
    got = got if return_mid else (got,)
    ref = ref if return_mid else (ref,)
    for ours, theirs in zip(got, ref):
        assert ours.dtype == dtype and ours.shape == theirs.shape
        assert bool(torch.isfinite(ours).all())
        _close(ours, theirs, dtype)
    if residual and not return_mid:  # no affines: 1 and 0
        _close(c1x1.conv1x1_pair(x, w1, w2, residual=res),
               c1x1.conv1x1_pair_torch(x, w1, w2, residual=res), dtype)


def _pair_plan(case, dev):
    lead, c1, cm, cout = case[:4]
    return c1x1.split_plan(int(np.prod(lead)), cm, cout, c1x1._sm_count(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [PAIR_CASES[i] for i in (0, 4, 6, 7)])
def test_cuda_conv1x1_pair_repeats_bitwise(case, dtype):
    """Two calls on the same inputs give bitwise equal y and mid: the split
    partials are summed in slice order, with no atomics."""
    dev = _need_cuda()
    lead, c1, cm, cout, residual, return_mid = case
    x, w1, w2, aff, res = _pair_inputs(lead, c1, cm, cout, residual, dtype,
                                       dev, seed=5)
    first = c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res,
                              return_mid=return_mid)
    again = c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res,
                              return_mid=return_mid)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [PAIR_CASES[i] for i in (4, 6, 7, 8)])
def test_cuda_conv1x1_pair_split_writes_every_element(case, dtype):
    """On the split path every element of y and mid is written: both
    outputs land in memory that held NaN (a NaN-filled tensor of each size,
    freed just before the call, which the caching allocator hands back: with
    its cache emptied first, those are its only free blocks)."""
    dev = _need_cuda()
    lead, c1, cm, cout, residual, return_mid = case
    assert _pair_plan(case, dev).slices > 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    x, w1, w2, aff, res = _pair_inputs(lead, c1, cm, cout, residual, dtype,
                                       dev, seed=6)
    nan_y = torch.full((*lead, cout), float("nan"), dtype=dtype, device=dev)
    nan_mid = torch.full((*lead, cm), float("nan"), dtype=dtype, device=dev)
    ptrs = (nan_y.data_ptr(), nan_mid.data_ptr())
    del nan_y, nan_mid
    y, mid = c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res,
                               return_mid=True)
    torch.cuda.synchronize()
    assert (y.data_ptr(), mid.data_ptr()) == ptrs
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(mid).all())
    ref = c1x1.conv1x1_pair_torch(x, w1, w2, *aff, residual=res,
                                  return_mid=True)
    for ours, theirs in zip((y, mid), ref):
        _close(ours, theirs, dtype)


def test_cuda_conv1x1_pair_refusals_and_launch_errors(monkeypatch):
    dev = _need_cuda()
    x, w1, w2, aff, res = _pair_inputs((40,), 64, 128, 64, True,
                                       torch.float32, dev)
    n0 = c1x1.launch_count()
    with pytest.raises(ValueError, match="return_mid requires residual"):
        c1x1.conv1x1_pair(x, w1, w2, *aff, return_mid=True)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        c1x1.conv1x1_pair(x.double(), w1.double(), w2.double(), *aff)
    with pytest.raises(MXNetError, match="w1 is torch.bfloat16"):
        c1x1.conv1x1_pair(x, w1.bfloat16(), w2, *aff)
    with pytest.raises(MXNetError, match="contiguous"):
        c1x1.conv1x1_pair(x, w1.t().contiguous().t(), w2, *aff)
    with pytest.raises(MXNetError, match="residual on cpu"):
        c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res.cpu())
    with pytest.raises(MXNetError, match="chain"):
        c1x1.conv1x1_pair(x, w2, w2, *aff)
    c1x1.force_path("torch")
    try:
        c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res)
        assert c1x1.last_path() == "torch"
    finally:
        c1x1.force_path(None)
    assert c1x1.launch_count() == n0
    # a launch the runtime refuses surfaces as MXNetError and is not counted
    lib = c1x1._lib()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def mxtt_conv1x1_pair(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(c1x1, "_LIB", Refusing())
    with pytest.raises(MXNetError, match="launch failed: invalid argument"):
        c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res)
    assert c1x1.launch_count() == n0

    # so is a refused launch of the reduce that follows a split launch
    class RefusingReduce:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def mxtt_conv1x1_pair_reduce(*args):
            return 1

    assert _pair_plan(((40,), 64, 128, 64), dev).slices > 1
    monkeypatch.setattr(c1x1, "_LIB", RefusingReduce())
    with pytest.raises(MXNetError, match="conv1x1_pair reduce kernel launch "
                       "failed: invalid argument"):
        c1x1.conv1x1_pair(x, w1, w2, *aff, residual=res)
    assert c1x1.launch_count() == n0


def test_cuda_fused_resnet_matches_cpu():
    """``fuse_resnet_v1`` on the card, every block boundary through the
    kernel (12 launches a forward), against the same model on the CPU: f32
    logits of the kernel arm, the library arm and the unfused model within
    1e-4 of the CPU's largest logit (cuDNN's TF32 would miss that); the
    bf16 kernel arm within 5e-2 of the f32 logits."""
    dev = _need_cuda()
    trandom.seed(0)
    cpu = get_resnet(1, 50, device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ref = cpu(x)
        scale = float(ref.abs().max())
        outs = {"unfused": gpu(x.to(dev))}
        for use_pallas in (True, False):
            fused = fuse_resnet_v1(gpu, dtype="float32",
                                   use_pallas=use_pallas)
            n0 = c1x1.launch_count()["pair_res_mid"]
            outs[use_pallas] = fused(x.to(dev))
            torch.cuda.synchronize()
            n = c1x1.launch_count()["pair_res_mid"] - n0
            assert n == (12 if use_pallas else 0), n
        bf = fuse_resnet_v1(gpu, use_pallas=True)(x.to(dev))
    for name, out in outs.items():
        err = float((out.cpu() - ref).abs().max()) / scale
        assert err < 1e-4, (name, err)
    assert bf.dtype == torch.float32
    assert float((bf.cpu() - ref).abs().max()) / scale < 5e-2


# ---------------------------------------------------------------------------
# multi-step decode: the super-step as CUDA graphs; paged KV on the card
# ---------------------------------------------------------------------------

MS_KW = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))
MS_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7]]


def _tiny_pair(dev):
    """The tiny Llama on the CPU and the same weights on the card."""
    trandom.seed(0)
    cpu_model = get_llama("llama_tiny_test", device="cpu")
    return cpu_model, copy.deepcopy(cpu_model).to(dev)


def _eager_super(gen, cache, steps, sampled, **arrays):
    """The super-step body run eagerly on the card, on the same kind of
    static buffers the graph reads: the yardstick of a replay."""
    from mxnet_tpu_torch.serve.generate import _SuperInputs

    b = len(arrays["start_pos"])
    pages = cache.pages_per_slot if gen._paged else 0
    inp = _SuperInputs(b, pages, gen.decode_steps, gen.device)
    if gen._paged:
        arrays["page_table"] = cache.table()
    inp.fill(**arrays)
    with torch.inference_mode():
        out = gen._mstep(*inp.views(), *cache.flat(), steps=steps,
                         sampled=sampled)
    return inp.read(out)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_cuda_multistep_graph_replay_equals_eager_body(rung, paged):
    """Super-steps replayed from CUDA graphs give the token blocks of the
    same body run eagerly on the card, visit after visit from one prefill,
    at N = 8 and N = 1, greedy and sampled, ring and paged; the graphs hold
    layers x steps kernel launches and each replay counts them."""
    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    kw = dict(MS_KW, decode_path=rung, paged=paged, page_size=8)
    for steps in (8, 1):
        for sampled in (False, True):
            ga = Generator(gpu, multistep=True, decode_steps=steps, **kw)
            gb = Generator(gpu, multistep=True, decode_steps=steps, **kw)
            ga.warmup()
            assert ga._msession.graphs and ga._msession.captures == (
                4 if steps > 1 else 2)
            toks, lens, bb = ga._pad_prompts(MS_PROMPTS)
            ca, cb = ga._fresh_cache(bb), gb._fresh_cache(bb)
            la, ca = ga.prefill(toks, lens, ca)
            lb, cb = gb.prefill(toks, lens, cb)
            ids = torch.argmax(la, -1).to(torch.int32).cpu().numpy()
            pos = lens.copy()
            arrays = dict(
                seeds=np.arange(bb, dtype=np.int32),
                temps=np.full(bb, 0.8 if sampled else 0.0, np.float32),
                top_ks=np.full(bb, 4 if sampled else 0, np.int32),
                stops=np.full((bb, 8), -1, np.int32),
                key_bits=np.array([3, 2 ** 31 + 5], np.uint32))
            key = (bb, steps, sampled, (None, None))
            for visit in range(3):
                rem = np.array([20, 20], np.int32)
                n0 = da.launch_count()
                blk_a, valid, done, ca = ga.decode_super(
                    ids, pos, steps, rem, arrays["seeds"], arrays["temps"],
                    arrays["top_ks"], arrays["stops"], arrays["key_bits"],
                    ca)
                assert da.launch_count() - n0 == 2 * steps
                assert ga._msession.launches(key) == [2 * steps] + (
                    [15 * steps] if rung == "int8" else [])
                packed = _eager_super(gb, cb, steps, sampled, tokens=ids,
                                      start_pos=pos, remaining=rem, **arrays)
                np.testing.assert_array_equal(blk_a, packed[:, :steps])
                assert valid.tolist() == [steps, steps]
                assert not done.any()
                ids = blk_a[:, -1].copy()
                pos = pos + steps
            ga.assert_no_recompiles()


def test_cuda_multistep_generate_matches_single_step_and_cpu(monkeypatch):
    """Greedy generate through graphs equals the card's single-step loop
    and the CPU's multi-step loop; launches = layers x N x visits
    (replay-aware: 11 decode tokens at N = 4 are 3 visits, 24 launches)."""
    _int8_branch_on_cpu(monkeypatch)
    dev = _need_cuda()
    cpu_model, gpu = _tiny_pair(dev)
    for rung in ("pallas", "int8"):
        kw = dict(MS_KW, decode_path=rung)
        gen = Generator(gpu, multistep=True, decode_steps=4, **kw)
        gen.warmup()
        single = Generator(gpu, **kw)
        cpu = Generator(cpu_model, multistep=True, decode_steps=4, **kw)
        n0 = da.launch_count()
        out, info = gen.generate(MS_PROMPTS, max_new_tokens=12)
        assert info["decode_visits"] == 3 and info["decode_steps"] == 11
        assert da.launch_count() - n0 == 2 * 4 * 3
        assert out == single.generate(MS_PROMPTS, max_new_tokens=12)[0]
        assert out == cpu.generate(MS_PROMPTS, max_new_tokens=12)[0]
        gen.assert_no_recompiles()


def test_cuda_multistep_force_path_reroutes():
    """A graph keeps the route it was captured on, so graphs are keyed by
    the routing: under force_path("torch") the super-step captures and
    replays the plain attention — no kernel launch — with the same greedy
    tokens."""
    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    gen = Generator(gpu, multistep=True, decode_steps=4, **MS_KW)
    gen.warmup()
    want, _ = gen.generate(MS_PROMPTS, max_new_tokens=12)
    captures = gen._msession.captures
    da.force_path("torch")
    try:
        n0 = da.launch_count()
        got, _ = gen.generate(MS_PROMPTS, max_new_tokens=12)
        assert da.launch_count() == n0
        assert da.last_path() == "torch"
    finally:
        da.force_path(None)
    assert got == want
    assert gen._msession.captures == captures + 1
    assert gen._msession.launches((2, 4, False, ("torch", None))) == [0]
    n0 = da.launch_count()
    assert gen.generate(MS_PROMPTS, max_new_tokens=12)[0] == want
    assert da.launch_count() - n0 == 2 * 4 * 3


def test_cuda_multistep_body_makes_no_host_sync():
    """Capture runs the body under set_sync_debug_mode("error"), and a
    replay too makes no host sync; a body that reads a device value on
    the host fails to capture, and the error raises."""
    from mxnet_tpu_torch.serve import GraphSession

    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    for paged in (False, True):
        gen = Generator(gpu, multistep=True, decode_steps=4, paged=paged,
                        page_size=8, **MS_KW)
        gen.warmup()
        toks, lens, bb = gen._pad_prompts(MS_PROMPTS)
        cache = gen._fresh_cache(bb)
        gen.prefill(toks, lens, cache)
        inp = gen._inputs[bb]
        zeros = np.zeros(bb, np.int32)
        arrays = dict(tokens=zeros, start_pos=lens, remaining=zeros + 8,
                      seeds=zeros, temps=np.ones(bb, np.float32),
                      top_ks=zeros, stops=np.full((bb, 8), -1, np.int32),
                      key_bits=np.array([1, 2], np.uint32))
        if paged:
            arrays["page_table"] = cache.table()
        inp.fill(**arrays)
        flat = cache.flat()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = gen._msession.run(
                (bb, 4, True, (None, None)),
                lambda: gen._mstep(*inp.views(), *flat, steps=4,
                                   sampled=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert tuple(inp.read(out).shape) == (bb, 6)
        gen.assert_no_recompiles()
    sess = GraphSession("bad", dev)
    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        sess.run("syncs", lambda: x * float(x.sum().item()))


def test_cuda_sample_step_matches_cpu_bits():
    """The counter-based draws are integer hashes and float64 Gumbel
    noise rounded to f32: the card gives the CPU's token ids."""
    dev = _need_cuda()
    rng = np.random.RandomState(4)
    b, v = 16, 128256
    logits = torch.from_numpy(rng.randn(b, v).astype(np.float32) * 3)
    temps = torch.from_numpy(rng.uniform(0.0, 1.5, b).astype(np.float32))
    tks = torch.from_numpy(rng.randint(0, 50, b).astype(np.int32))
    seeds = torch.arange(b, dtype=torch.int32)
    pos = torch.from_numpy(rng.randint(0, 8000, b).astype(np.int32))
    key = torch.tensor([2 ** 32 - 3, 17])
    cpu = tops.sample_step(logits, temps, tks, seeds, pos, key)
    gpu = tops.sample_step(*(t.to(dev) for t in (logits, temps, tks, seeds,
                                                 pos, key)))
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_paged_ops_match_cpu(quant):
    """paged_kv_gather / paged_kv_scatter on the card give the CPU's bytes
    (exact copies), the scale pools too, with the null page re-zeroed."""
    dev = _need_cuda()
    rng = np.random.RandomState(5)
    p, kv, pg, d, n = 40, 8, 32, 128, 4
    if quant:
        pool = torch.from_numpy(rng.randint(-127, 128, (p, kv, pg, d))
                                .astype(np.int8))
    else:
        pool = torch.from_numpy(rng.randn(p, kv, pg, d).astype(np.float32))
    scales = torch.from_numpy(rng.rand(p, kv, pg).astype(np.float32))
    table = torch.from_numpy(np.array([[1, 2, 3, 4], [9, 8, 0, 0],
                                       [0, 0, 0, 0], [5, 6, 7, 10]],
                                      np.int32))
    start = torch.tensor([30, 50, 3, 120], dtype=torch.int32)
    for src in (pool, scales):
        ring = tops.paged_kv_gather(src, table)
        gring = tops.paged_kv_gather(src.to(dev), table.to(dev))
        assert torch.equal(gring.cpu(), ring)
        new = ring.clone()
        new.view(-1)[::7] = 0
        for length in (1, 8):
            a = tops.paged_kv_scatter(src.clone(), table, new, start, length)
            b = tops.paged_kv_scatter(src.clone().to(dev), table.to(dev),
                                      new.to(dev), start.to(dev), length)
            assert torch.equal(b.cpu(), a) and not b[0].any()


# ---------------------------------------------------------------------------
# the continuous-batching engine on the card
# ---------------------------------------------------------------------------

CB_KW = dict(max_seq=64, num_slots=2, page_size=8, prefill_chunk=8)
CB_WAIT = 120


def _cb_prompts(n, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=int(k))]
            for k in rng.randint(1, 30, size=n)]


def _cb_serve(eng, prompts, budgets, **kw):
    futs = [eng.submit(p, max_new_tokens=int(m), **kw)
            for p, m in zip(prompts, budgets)]
    return [f.result(timeout=CB_WAIT)["tokens"] for f in futs]


def _cb_engine(model, **kw):
    from mxnet_tpu_torch.serve import ContinuousEngine

    return ContinuousEngine(model, **dict(CB_KW, **kw))


@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_cuda_engine_captures_only_in_warmup_across_churn(rung, monkeypatch):
    """warmup() captures the super-step's four graphs (N and 1, greedy and
    sampled); 24 requests churning through 2 slots on the scheduler thread
    capture none, keep every signature, recycle every page and give the
    CPU engine's greedy tokens."""
    _int8_branch_on_cpu(monkeypatch)
    dev = _need_cuda()
    cpu_model, gpu = _tiny_pair(dev)
    prompts = _cb_prompts(24, seed=1)
    budgets = np.random.RandomState(2).randint(1, 12, size=24)
    eng = _cb_engine(gpu, decode_path=rung, multistep=True, decode_steps=4,
                     max_queue=64)
    try:
        w = eng.warmup()
        assert w["captures"] == 4 and eng._msession.graphs
        eng.start()
        got = _cb_serve(eng, prompts, budgets)
        assert eng._msession.captures == 4
        eng.assert_no_recompiles()
        st = eng.stats()["pool"]
        assert st["pages_owned"] == 0 and st["pages_used"] == 0
    finally:
        eng.close()
    with _cb_engine(cpu_model, decode_path=rung, multistep=True,
                    decode_steps=4, max_queue=64) as cpu:
        assert got == _cb_serve(cpu, prompts, budgets)


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_cuda_engine_greedy_matches_cpu_and_counts_replays(multistep):
    """Greedy tokens on the card equal the same engine's on the CPU, and
    the decode-attention kernel's launches equal layers x the decode
    iterations the engine ran (each graph replay counted)."""
    dev = _need_cuda()
    cpu_model, gpu = _tiny_pair(dev)
    prompts = _cb_prompts(6, seed=3)
    budgets = [9, 3, 12, 1, 7, 5]
    kw = dict(decode_path="pallas", multistep=multistep, decode_steps=4)
    eng = _cb_engine(gpu, **kw)
    try:
        eng.warmup()
        n0 = da.launch_count()
        eng.start()
        got = _cb_serve(eng, prompts, budgets)
        launches = da.launch_count() - n0
        st = eng.stats()
        eng.assert_no_recompiles()
    finally:
        eng.close()
    iterations = st["decode_iterations"]
    assert launches == 2 * iterations > 0
    if not multistep:
        assert iterations == st["decode_visits"]
    with _cb_engine(cpu_model, **kw) as cpu:
        assert got == _cb_serve(cpu, prompts, budgets)


def test_cuda_engine_sampled_n8_equals_n1():
    """Sampled streams are keyed by (engine key, admission seed,
    position): N = 8 and N = 1 on the card give the same tokens, and the
    greedy lanes riding in the same sampled visits keep their greedy
    tokens."""
    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    prompts = _cb_prompts(4, seed=4)
    outs = []
    for steps in (8, 1):
        trandom.seed(5)
        with _cb_engine(gpu, num_slots=4, multistep=True,
                        decode_steps=steps) as eng:
            futs = [eng.submit(p, max_new_tokens=14,
                               temperature=0.0 if i == 0 else 0.9, top_k=6)
                    for i, p in enumerate(prompts)]
            outs.append([f.result(timeout=CB_WAIT)["tokens"] for f in futs])
            eng.assert_no_recompiles()
    assert outs[0] == outs[1]
    with _cb_engine(gpu, num_slots=4) as greedy:
        assert outs[0][0] == _cb_serve(greedy, prompts[:1], [14])[0]


def test_cuda_engine_forced_plain_captures_on_the_scheduler_thread():
    """Under force_path("torch") the scheduler thread captures the plain
    route's graph at first use (a thread other than warmup's) and replays
    it: no kernel launch, the same greedy tokens."""
    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    prompts = _cb_prompts(3, seed=6)
    with _cb_engine(gpu, multistep=True, decode_steps=4) as eng:
        want = _cb_serve(eng, prompts, [10, 10, 10])
        da.force_path("torch")
        try:
            n0 = da.launch_count()
            got = _cb_serve(eng, prompts, [10, 10, 10])
            assert da.launch_count() == n0
        finally:
            da.force_path(None)
        assert eng._msession.captures == 5
    assert got == want


# ---------------------------------------------------------------------------
# speculative decoding and the session watchdog on the card
# ---------------------------------------------------------------------------


def _spec(gpu, draft, **kw):
    from mxnet_tpu_torch.serve import SpeculativeGenerator

    return SpeculativeGenerator(gpu, draft, **dict(MS_KW, k=3, **kw))


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_cuda_verify_graph_replay_equals_eager_body(rung, paged):
    """The verify pass replayed from its CUDA graph gives the logits and
    greedy ids of the same body run eagerly on the card over the same
    prefilled cache, round after round; the graph launches no
    decode-attention kernel (T = k+1 takes the plain attention)."""
    from mxnet_tpu_torch.serve.generate import _VerifyInputs

    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    kw = dict(decode_path=rung, paged=paged, page_size=8)
    sa, sb = _spec(gpu, gpu, **kw), _spec(gpu, gpu, **kw)
    sa.warmup()
    assert sa._verify.graphs and sa._verify.captures == 1
    toks, lens, bb = sa.target._pad_prompts(MS_PROMPTS)
    ca, cb = sa.target._fresh_cache(bb), sb.target._fresh_cache(bb)
    _, ca = sa.target.prefill(toks, lens, ca)
    _, cb = sb.target.prefill(toks, lens, cb)
    rng = np.random.RandomState(0)
    pos = lens.copy()
    for _ in range(3):
        blk = rng.randint(1, 256, size=(bb, 4)).astype(np.int32)
        n0 = da.launch_count()
        logits, ids, ca = sa._verify_run(blk, pos, ca)
        assert da.launch_count() == n0
        inp = _VerifyInputs(bb, 4, cb.pages_per_slot if paged else 0, dev)
        arrays = dict(tokens=blk, start_pos=pos,
                      last_idx=np.zeros(bb, np.int32))
        if paged:
            arrays["page_table"] = cb.table()
        inp.fill(**arrays)
        with torch.inference_mode():
            want = sb._verify_step(*inp.views(), *cb.flat())[0]
        torch.testing.assert_close(logits, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            ids, torch.argmax(want, -1).to(torch.int32).cpu().numpy())
        pos = pos + 2
    assert sa._verify.launches((bb, 4, (None, None))) == [0] + (
        [15] if rung == "int8" else [])
    sa.assert_no_recompiles()


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_cuda_speculative_matches_generator_and_cpu(multistep):
    """A tiny speculative generator on the card gives the card
    ``Generator``'s greedy tokens and the CPU speculative generator's, for
    a copied draft and a random one; a round is two host visits with
    ``multistep`` (one draft replay, one verify replay); the kernel
    launches are the draft's layers x (k+1) x rounds; nothing is captured
    after warmup."""
    dev = _need_cuda()
    cpu_model, gpu = _tiny_pair(dev)
    trandom.seed(1)
    cpu_draft = get_llama("llama_tiny_test", device="cpu", num_layers=1)
    gpu_draft = copy.deepcopy(cpu_draft).to(dev)
    want = Generator(gpu, **MS_KW).generate(MS_PROMPTS,
                                            max_new_tokens=12)[0]
    for cpu_d, gpu_d in ((cpu_model, gpu), (cpu_draft, gpu_draft)):
        layers = len(gpu_d._blocks)
        sg = _spec(gpu, gpu_d, multistep=multistep)
        sg.warmup()
        caps = (sg._verify.captures,
                sg.draft._msession.captures if multistep else 0)
        vr0 = sg._verify.replays
        dr0 = sg.draft._msession.replays if multistep else 0
        n0 = da.launch_count()
        out, info = sg.generate(MS_PROMPTS, max_new_tokens=12)
        rounds = info["rounds"]
        assert out == want
        assert da.launch_count() - n0 == layers * 4 * rounds
        assert sg._verify.replays - vr0 == rounds
        if multistep:
            assert sg.draft._msession.replays - dr0 == rounds
            assert info["decode_visits"] == 2 * rounds
            assert sg.draft._msession.captures == caps[1]
        assert sg._verify.captures == caps[0]
        sg.assert_no_recompiles()
        cpu = _spec(cpu_model, cpu_d, multistep=multistep)
        assert out == cpu.generate(MS_PROMPTS, max_new_tokens=12)[0]


def _record_set_device(monkeypatch):
    """Patch ``torch.cuda.set_device`` to record (thread name, device
    index) for every call, then make the call."""
    import threading

    calls = []
    real = torch.cuda.set_device

    def spy(device):
        calls.append((threading.current_thread().name,
                      device if isinstance(device, int)
                      else torch.device(device).index))
        return real(device)

    monkeypatch.setattr(torch.cuda, "set_device", spy)
    return calls


def test_cuda_session_watchdog_thread_sets_device_and_inference_mode(
        monkeypatch):
    """With ``MXNET_SERVE_TIMEOUT_MS`` set, a session's CUDA body runs on
    the watchdog's thread, which calls ``torch.cuda.set_device`` with the
    session's device before the body and makes the caller's stream
    current, under ``torch.inference_mode()``, recording no autograd
    graph; warmup runs inline; a hung body becomes a 503."""
    from mxnet_tpu_torch.resilience import faults as tfaults
    from mxnet_tpu_torch.serve import InferenceSession, ServiceUnavailable

    dev = _need_cuda()
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(8, 8)

        def forward(self, x):
            import threading

            seen.append((threading.current_thread().name,
                         torch.cuda.current_device(),
                         torch.cuda.current_stream(),
                         torch.is_inference_mode_enabled(),
                         torch.is_grad_enabled()))
            return self.lin(x)

    block = Probe().to(dev)
    sess = InferenceSession(block, batch_buckets=(2,), name="wd")
    x = np.ones((2, 8), np.float32)
    monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "60000")
    sess.warmup(x)
    assert "watchdog" not in seen[-1][0]
    calls = _record_set_device(monkeypatch)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        out = sess.predict(x)
    side.synchronize()
    name, device, stream, inference, grad = seen[-1]
    assert "mxtpu-watchdog[serve:wd]" == name
    assert calls == [(name, dev.index)]
    assert device == dev.index and stream == side
    assert inference and not grad
    assert out.device == dev and not out.requires_grad
    torch.testing.assert_close(out, block.lin(torch.ones(2, 8,
                                                         device=dev)))
    monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "50")
    tfaults.install_plan({"rules": [{"site": "serve:execute",
                                     "kind": "delay", "seconds": 0.3,
                                     "times": 1}]})
    try:
        with pytest.warns(RuntimeWarning, match="watchdog abandoned"):
            with pytest.raises(ServiceUnavailable,
                               match="MXNET_SERVE_TIMEOUT_MS"):
                sess.predict(x)
    finally:
        tfaults.clear_plan()


def test_cuda_graph_replay_under_the_watchdog_and_drain(monkeypatch):
    """With ``MXNET_SERVE_TIMEOUT_MS`` set after warmup, a multi-step
    generator's super-step graphs replay on the watchdog's thread (which
    sets the device first) on the caller's stream, with the tokens and
    kernel launch counts of an unwatched run and no new capture; draining
    the generator's session refuses the next replay with a 503."""
    from mxnet_tpu_torch.serve import ServiceUnavailable
    from mxnet_tpu_torch.serve.generate import _STOP_WIDTH

    dev = _need_cuda()
    _, gpu = _tiny_pair(dev)
    gen = Generator(gpu, multistep=True, decode_steps=4, **MS_KW)
    gen.warmup()
    caps = gen._msession.captures
    want, info = gen.generate(MS_PROMPTS, max_new_tokens=12)
    monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "60000")
    calls = _record_set_device(monkeypatch)
    side = torch.cuda.Stream(dev)
    for stream in (None, side):
        n0, r0 = da.launch_count(), gen._msession.replays
        with torch.cuda.stream(stream):
            out, got = gen.generate(MS_PROMPTS, max_new_tokens=12)
        assert out == want
        assert gen._msession.replays - r0 == got["decode_visits"]
        assert da.launch_count() - n0 == (
            len(gpu._blocks) * 4 * got["decode_visits"])
    watched = [c for c in calls if c[0] == "mxtpu-watchdog[serve:"
               f"{gen._msession.name}]"]
    assert watched and all(d == dev.index for _, d in watched)
    assert gen._msession.captures == caps
    gen.assert_no_recompiles()
    assert gen.session.drain(timeout=5.0)
    try:
        with pytest.raises(ServiceUnavailable, match="draining"):
            gen.decode_super(*([np.zeros(2, np.int32)] * 2), 4,
                             np.zeros(2, np.int32), np.zeros(2, np.int32),
                             np.zeros(2, np.float32), np.zeros(2, np.int32),
                             np.full((2, _STOP_WIDTH), -1, np.int32),
                             np.zeros(2, np.uint32), gen._fresh_cache(2))
    finally:
        gen.session.resume()


# -- BERT and the Transformer (slice A.5) -------------------------------------

BERT_TINY = dict(units=32, hidden_size=64, num_layers=2, num_heads=4,
                 vocab_size=100, max_length=64, dropout=0.0)


def _bert_tokens(b=3, t=16, seed=0, zero_row=True):
    """Token ids with padded tails (valid lengths t, t // 2 + 1, ...) and,
    with ``zero_row``, a last row of padding only (valid length 0)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 100, (b, t)).astype(np.int64)
    toks[1:2, t // 2 + 1:] = 0
    if zero_row:
        toks[-1] = 0
    return torch.from_numpy(toks)


def _routes(fn):
    """``fn()`` on the kernels, then with the plain attention forced."""
    out = fn()
    fa.force_path("torch")
    try:
        plain = fn()
    finally:
        fa.force_path(None)
    return out, plain


def _tiny_bert(dev, head):
    from mxnet_tpu_torch import models

    trandom.seed(0)
    bert = models.get_bert_model(device=dev, **BERT_TINY)
    block = (models.BERTForPretrain(bert) if head == "pretrain"
             else models.BERTClassifier(bert, num_classes=3, dropout=0.0))
    return models.BERTStep(block)


def test_cuda_bert_kernel_route_matches_plain():
    """The wrapped ``BERTForPretrain`` at the tiny size on the card: MLM
    and NSP scores and every weight's gradient on the kernels against the
    plain attention, a row of valid length 0 finite; 2 layers launch each
    flash kernel twice a forward and backward on the f32 pair."""
    dev = _need_cuda()
    net = _tiny_bert(dev, "pretrain")
    toks = _bert_tokens().to(dev)

    def run():
        net.zero_grad()
        mlm, nsp = net(toks)
        (mlm.sum() + nsp.sum()).backward()
        return (mlm.detach(), nsp.detach(),
                {n: p.grad.clone() for n, p in net.named_parameters()})

    n0 = fa.launch_count((torch.float32, torch.float32))
    (mlm, nsp, grads), (p_mlm, p_nsp, p_grads) = _routes(run)
    got = fa.launch_count((torch.float32, torch.float32))
    assert got == {k: n0[k] + 2 for k in fa.KERNELS}
    for ours, ref in ((mlm, p_mlm), (nsp, p_nsp)):
        assert bool(torch.isfinite(ours).all())
        assert float((ours - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    scale = max(float(g.abs().max()) for g in p_grads.values())
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        assert float((g - p_grads[name]).abs().max()) <= 1e-5 * scale, name


def test_cuda_transformer_kernel_route_matches_plain():
    """Transformer at the tiny size (2 + 2 layers): the encoder's
    non-causal attention with valid lengths (one 0), the decoder's causal
    self-attention and its cross-attention with Tq != Tk, forward and
    gradients on the kernels against the plain attention; 6 launches of
    each kernel a forward and backward."""
    from mxnet_tpu_torch import models

    dev = _need_cuda()
    trandom.seed(0)
    net = models.Transformer(50, units=32, hidden_size=64, num_heads=4,
                             num_encoder_layers=2, num_decoder_layers=2,
                             dropout=0.0, tie_embeddings=True, device=dev)
    rng = np.random.RandomState(1)
    src = torch.from_numpy(rng.randint(0, 50, (3, 12))).to(dev)
    tgt = torch.from_numpy(rng.randint(0, 50, (3, 7))).to(dev)
    svl = torch.tensor([12, 5, 0], device=dev)

    def run():
        net.zero_grad()
        out = net(src, tgt, svl)
        out.square().sum().backward()
        return out.detach(), {n: p.grad.clone()
                              for n, p in net.named_parameters()}

    n0 = fa.launch_count()
    (out, grads), (p_out, p_grads) = _routes(run)
    assert fa.launch_count() == {k: n0[k] + 6 for k in fa.KERNELS}
    assert bool(torch.isfinite(out).all())
    assert float((out - p_out).abs().max()) <= 1e-5 * float(
        p_out.abs().max())
    scale = max(float(g.abs().max()) for g in p_grads.values())
    for name, g in grads.items():
        assert float((g - p_grads[name]).abs().max()) <= 1e-5 * scale, name


def test_cuda_bert_bf16_step_launches_the_bf16_pair():
    """``ShardedTrainer(dtype="bfloat16")`` on the wrapped
    ``BERTForPretrain`` (dropout 0.1): every attention is (bf16, bf16), so
    each kernel launches once a layer a step on that pair and on no other;
    the loss is finite and falls; a ``step_n`` window of three from the
    same seed gives the steps' losses bit for bit."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer

    dev = _need_cuda()
    toks = _bert_tokens(4, 16, zero_row=False).to(dev)
    mlm = torch.from_numpy(np.random.RandomState(2).randint(
        1, 100, (4, 16))).to(dev)
    nsp = torch.tensor([0, 1, 1, 0], device=dev)
    ce = tloss.SoftmaxCrossEntropyLoss()

    def loss_fn(outs, labels):
        return ce(outs[0], labels[0]).mean() + ce(outs[1], labels[1]).mean()

    runs = []
    for windowed in (False, True):
        trandom.seed(0)
        net = models.BERTStep(models.BERTForPretrain(models.get_bert_model(
            device=dev, **dict(BERT_TINY, dropout=0.1))))
        tr = ShardedTrainer(net, loss_fn, "adam", {"learning_rate": 1e-3},
                            dtype="bfloat16")
        fa.reset_launch_count()
        if windowed:
            losses = [float(x) for x in tr.step_n(
                toks.expand(3, -1, -1), (mlm.expand(3, -1, -1),
                                         nsp.expand(3, -1)))]
        else:
            losses = [float(tr.step(toks, (mlm, nsp))) for _ in range(3)]
        launched = {fa.pair_label(p): fa.launch_count(p)
                    for p in fa.DTYPE_PAIRS}
        runs.append(losses)
        zero = dict.fromkeys(fa.KERNELS, 0)
        assert launched == {**{k: zero for k in launched},
                            "bf16": dict.fromkeys(fa.KERNELS, 2 * 3)}
    assert runs[0] == runs[1]
    assert all(np.isfinite(runs[0])) and runs[0][2] < runs[0][0]


def test_cuda_bert_session_signatures_frozen_after_warmup():
    """The wrapped classifier served on the card over (batch, seq)
    buckets: after ``warmup()`` no request brings a new signature, each
    forward launches the flash forward once a layer, the padding-only row
    (valid length 0) gives finite logits, and the logits match the CPU's
    plain run of the same weights."""
    from mxnet_tpu_torch.serve import InferenceSession

    dev = _need_cuda()
    net = _tiny_bert(dev, "classifier").eval()
    cpu = copy.deepcopy(net).cpu()
    kw = dict(batch_buckets=(1, 4), seq_buckets=(8, 16), pad_value=0)
    sess = InferenceSession(net, **kw)
    cpu_sess = InferenceSession(cpu, device="cpu", **kw)
    reqs = [_bert_tokens(1, 5, zero_row=False).numpy(),
            _bert_tokens(3, 12).numpy(), _bert_tokens(4, 16).numpy()]
    assert sess.warmup(reqs[0]) == 4
    forwards = []
    hook = net.register_forward_pre_hook(lambda m, a: forwards.append(1))
    n0 = fa.launch_count()
    for r in reqs:
        out = sess.predict(r)
        ref = cpu_sess.predict(r)
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-4)
    hook.remove()
    sess.assert_no_recompiles()
    assert sess.signature_count() == 4
    assert fa.launch_count() == {"fwd": n0["fwd"] + 2 * len(forwards),
                                 "bwd_dq": n0["bwd_dq"],
                                 "bwd_dkv": n0["bwd_dkv"]}


# ---------------------------------------------------------------------------
# ResNet training (slice A.4): C3, train-mode BatchNorm, ShardedTrainer,
# the optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    ((2, 3, 64, 64), (16, 3, 7, 7), 2, 3),
    ((2, 32, 28, 28), (32, 32, 3, 3), 1, 1),
    ((2, 64, 28, 28), (128, 64, 1, 1), 2, 0)],
    ids=["stem_7x7_s2", "3x3", "1x1_s2"])
def test_cuda_f32_convolution_gradients_full_f32(case):
    """C3: the port's f32 convolution on the card, forward and both
    gradients, within 1e-5 of float64 (as a share of the largest value),
    where cuDNN's default TF32 keeps about three digits; no global flag
    moves."""
    dev = _need_cuda()
    xs, ws, stride, pad = case
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(xs, generator=gen)
    w = torch.randn(ws, generator=gen) / ws[1] ** 0.5
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    y64 = torch.nn.functional.conv2d(x64, w64, None, stride, pad)
    gy = torch.randn(y64.shape, generator=gen)
    y64.backward(gy.double())
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    xc = x.to(dev).requires_grad_()
    wc = w.to(dev).requires_grad_()
    yc = tops.convolution(xc, wc, None, stride, pad)
    yc.backward(gy.to(dev))
    for got, want in ((yc, y64), (xc.grad, x64.grad), (wc.grad, w64.grad)):
        want = want.detach()
        err = (got.detach().double().cpu() - want).abs().max()
        assert float(err / want.abs().max()) <= 1e-5
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags


def test_cuda_bf16_batch_norm_matches_cpu():
    """Train-mode bf16 ``batch_norm``: forward and gradients on the card
    against the CPU, within 2 units in bf16's last place of each output's
    largest value (the reductions add in other orders); the f32 batch
    statistics to 1e-5."""
    dev = _need_cuda()
    rng = np.random.RandomState(0)
    arrs = [rng.randn(8, 16, 14, 14) * 2 + 1, rng.uniform(0.5, 1.5, 16),
            rng.randn(16), rng.randn(8, 16, 14, 14)]
    outs = {}
    for d in ("cpu", dev):
        x, g, b, dy = (torch.from_numpy(a.astype(np.float32)).to(d)
                       for a in arrs)
        x, g, b = (t.bfloat16().requires_grad_() for t in (x, g, b))
        out, mean, var = tops.batch_norm(
            x, g, b, None, None, output_mean_var=True, training=True)
        (out.float() * dy).sum().backward()
        outs[str(d)] = [t.detach().float().cpu() for t in
                        (out, mean, var, x.grad, g.grad, b.grad)]
    for i, (a, b) in enumerate(zip(outs[str(dev)], outs["cpu"])):
        scale = float(b.abs().max())
        tol = 1e-5 if i in (1, 2) else 2 * 2.0 ** -8
        assert float((a - b).abs().max()) <= tol * scale, i


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_cuda_resnet_sharded_step_matches_cpu(dtype):
    """One ``ShardedTrainer`` SGD step of a small bottleneck ResNetV1 on
    the card against the CPU, then a ``step_n`` window equal to two
    ``step()`` calls. f32: the loss within 1e-5, the weights and running
    statistics within 1e-4 of their movement (the C3 repair: TF32 alone
    would move them ~1e-3); bf16: the loss within 1e-2 and the statistics
    f32 on both."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel import ShardedTrainer

    dev = _need_cuda()
    base = initializer.initialize(
        vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                        [8, 16, 32, 64, 128], classes=10, thumbnail=True),
        "xavier", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 3, 32, 32)).astype(
        np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (3, 4)))
    init = {n: t.detach().double().clone()
            for n, t in base.state_dict().items()}
    runs = {}
    for d in ("cpu", dev):
        model = copy.deepcopy(base).to(d)
        tr = ShardedTrainer(model, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4}, dtype=dtype)
        loss = float(tr.step(x[0].to(d), y[0].to(d)))
        runs[str(d)] = (loss, {n: t.detach().double().cpu()
                               for n, t in model.state_dict().items()}, tr)
        assert all(m.running_var.dtype == torch.float32
                   for m in model.modules() if hasattr(m, "running_var"))
    (l_cpu, s_cpu, _), (l_dev, s_dev, tr) = runs["cpu"], runs[str(dev)]
    if dtype is None:
        assert abs(l_dev - l_cpu) <= 1e-5
        for stats in (False, True):
            keys = [n for n in s_cpu if ("running" in n) == stats
                    and s_cpu[n].is_floating_point()]
            diff = sum(float(((s_dev[n] - s_cpu[n]) ** 2).sum())
                       for n in keys) ** 0.5
            moved = sum(float(((s_cpu[n] - init[n]) ** 2).sum())
                        for n in keys) ** 0.5
            assert diff <= 1e-4 * moved, (stats, diff, moved)
    else:
        assert abs(l_dev - l_cpu) <= 1e-2
    # step_n over the next two batches equals two step() calls from here
    model = tr.block
    twin = copy.deepcopy(model)
    tr2 = ShardedTrainer(twin, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9,
                          "wd": 1e-4}, dtype=dtype)
    tr2._opt_states = [tuple(s.clone() for s in st)
                       for st in tr._opt_states]
    tr2._step_count = tr._step_count
    fused = tr.step_n(x[1:].to(dev), y[1:].to(dev))
    seq = torch.stack([tr2.step(x[i].to(dev), y[i].to(dev))
                       for i in (1, 2)])
    assert torch.allclose(fused, seq, rtol=0, atol=1e-3 if dtype else 1e-5)
    assert tr.step_flops == tr2.step_flops > 0


@pytest.mark.parametrize("name", ["nag", "rmsprop", "adagrad", "adadelta",
                                  "adamax", "nadam", "ftrl", "ftml",
                                  "signum", "lars", "lamb", "lans",
                                  "dcasgd"])
def test_cuda_optimizer_updates_match_cpu(name):
    """The new optimizers' in-place rules on the card against the CPU:
    four updates of two weights, to 1e-6 (relative, and absolute at the
    weights' scale). SGLD is held on its deterministic part: its noise is
    a device stream."""
    from mxnet_tpu_torch import optimizer as topt

    dev = _need_cuda()
    rng = np.random.RandomState(0)
    ws = [rng.randn(64, 33).astype(np.float32), rng.randn(17).astype(
        np.float32)]
    gs = [[rng.randn(*w.shape).astype(np.float32) for w in ws]
          for _ in range(4)]
    out = {}
    for d in ("cpu", dev):
        opt = topt.create(name, learning_rate=0.01, wd=0.01,
                          rescale_grad=0.5, clip_gradient=0.8)
        weights = [torch.from_numpy(w.copy()).to(d) for w in ws]
        states = [opt.create_state(i, w) for i, w in enumerate(weights)]
        for grads in gs:
            for i, (w, g) in enumerate(zip(weights, grads)):
                opt.update(i, w, torch.from_numpy(g).to(d), states[i])
        out[str(d)] = [w.cpu() for w in weights]
    for a, b in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * max(1.0, float(b.abs().max())))


def test_cuda_sgld_deterministic_part_matches_cpu():
    from mxnet_tpu_torch import optimizer as topt

    dev = _need_cuda()
    w = torch.randn(128, 64, generator=torch.Generator().manual_seed(0))
    g = torch.randn(128, 64, generator=torch.Generator().manual_seed(1))
    t = w.clone().to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    topt.SGLD(learning_rate=0.01, wd=0.01, generator=gen).update(
        0, t, g.to(dev), ())
    noise = torch.randn(w.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3)
                        ) * 0.1
    det = w - 0.5 * 0.01 * (g + 0.01 * w)
    torch.testing.assert_close((t - noise).cpu(), det, rtol=0, atol=1e-6)


# -- the int8 x int8 product (ops/hopper/int8_dense) ---------------------------


def _int8_inputs(m, o, u, dev, seed=0):
    """Normal activations with a row of zeros and a row of exact .5 ties
    (amax 127, so sx = 1), a random int8 weight and per-channel scales."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, u).astype(np.float32)
    if m >= 3:
        x[1] = 0.0
        x[2] = 0.0
        x[2, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5][:min(u, 6)]
    w = rng.randint(-127, 128, size=(o, u)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, size=o).astype(np.float32)
    b = rng.randn(o).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, w, s, b))


@pytest.mark.parametrize("m", [1, 4, 17, 130])
@pytest.mark.parametrize("u,o", [(30, 37), (4096, 1024)])
def test_cuda_int8_dense_matches_plain_bitwise(m, u, o):
    """The kernel equals its plain version bit for bit (the int32 sums
    are exact and the rescale rounds op by op in both), split or not, and
    two calls repeat bit for bit; one launch a call."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(m, o, u, dev, seed=m)
    n0 = i8.launch_count()
    for bias in (None, b):
        out = i8.int8_dense(x, w, s, bias)
        assert i8.last_path() == "cuda"
        again = i8.int8_dense(x, w, s, bias)
        ref = i8.int8_dense_torch(x, w, s, bias)
        assert torch.equal(out, ref), float((out - ref).abs().max())
        assert torch.equal(out, again)
    assert i8.launch_count() == n0 + 4
    plan = i8.split_plan(m, o, u, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    if (m, u) == (4, 4096):
        assert plan.slices > 1  # the decode shape splits U


def test_cuda_int8_dense_misaligned_and_batched():
    """A weight and an x that start off a 16-byte boundary (byte and float
    loads) and a (2, 3, U) x give the plain version's bits; the pieces
    (row quantization, product) give the whole call's."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(6, 1024, 4096, dev, seed=9)
    xm, wm = _misaligned(x), _misaligned(w)
    assert xm.data_ptr() % 16 and wm.data_ptr() % 16
    ref = i8.int8_dense_torch(x, w, s, b)
    assert torch.equal(i8.int8_dense(xm, wm, s, b), ref)
    x3 = x.reshape(2, 3, 4096)
    assert torch.equal(i8.int8_dense(x3, w, s), i8.int8_dense_torch(x3, w, s))
    xq, sx = i8.quantize_rows(x)
    pq, psx = i8.quantize_rows_torch(x)
    assert torch.equal(xq[:, :4096], pq) and torch.equal(sx, psx[:, 0])
    assert torch.equal(i8.product(xq, sx, 4096, w, s, b), ref)


def test_cuda_int8_dense_replays_in_a_cuda_graph():
    """One call captured in a CUDA graph records one launch
    (``captured_count``), runs none, and replays after x changes in place
    give the plain version's bits; ``count_replays`` adds each replay."""
    dev = _need_cuda()
    x, w, s, _ = _int8_inputs(4, 1024, 4096, dev, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        i8.int8_dense(x, w, s)  # warm: builds the library, sizes the pool
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0, c0 = i8.launch_count(), i8.captured_count()
    with torch.cuda.graph(graph):
        out = i8.int8_dense(x, w, s)
    assert i8.captured_count() == c0 + 1 and i8.launch_count() == n0
    for seed in (4, 5, 6):
        x.copy_(_int8_inputs(4, 1024, 4096, dev, seed=seed)[0])
        graph.replay()
        i8.count_replays(1)
        torch.cuda.synchronize()
        assert torch.equal(out, i8.int8_dense_torch(x, w, s))
    assert i8.launch_count() == n0 + 3


def test_cuda_int8_dense_kernels_do_not_spill():
    dev = _need_cuda()
    del dev
    attrs = i8.kernel_attributes()
    assert sorted(attrs) == sorted(i8.KERNELS)
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
        assert a["registers"] <= 255


def test_cuda_int8_dense_refusals_and_forced_plain():
    """Wrong dtypes, shapes, devices or contiguity raise and launch
    nothing; ``force_path("torch")`` takes the plain version on the card."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(4, 37, 30, dev)
    n0 = i8.launch_count()
    for args, match in (((x.double(), w, s), "float32"),
                        ((x, w.float(), s), "int8"),
                        ((x[:, :16], w, s), "does not match"),
                        ((x, w, s.double()), "scale must be float32"),
                        ((x, w, s[:5]), "scale must be float32"),
                        ((x, w, s, b.cpu()), "bias on cpu"),
                        ((x, w.t().contiguous().t(), s), "not contiguous")):
        with pytest.raises(MXNetError, match=match):
            i8.int8_dense(*args)
    assert i8.launch_count() == n0
    i8.force_path("torch")
    try:
        out = i8.int8_dense(x, w, s)
        assert i8.last_path() == "torch" and i8.launch_count() == n0
    finally:
        i8.force_path(None)
    assert torch.equal(out, i8.int8_dense_torch(x, w, s))
    assert torch.equal(tops.quantized_dense(x, w, s), out)


# -- the int8 product's prefill rows on the wgmma kernel ----------------------


@pytest.mark.parametrize("m", [33, 64, 130, 256, 1024])
@pytest.mark.parametrize("u,o", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 1001)])
def test_cuda_int8_dense_wgmma_matches_plain_bitwise(m, u, o):
    """Prefill rows on an aligned weight take the wgmma kernel, which
    equals the plain version bit for bit (with and without a bias, split
    or not; O = 1001 leaves a ragged last tile at either width and output
    rows that are not 8-byte aligned), and two calls repeat bit for bit;
    one launch a call."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(m, o, u, dev, seed=m + o)
    assert i8.takes_wgmma(m, u, w.data_ptr())
    n0, r0 = i8.launch_count(), i8.route_launches()
    for bias in (None, b):
        out = i8.int8_dense(x, w, s, bias)
        again = i8.int8_dense(x, w, s, bias)
        ref = i8.int8_dense_torch(x, w, s, bias)
        assert torch.equal(out, ref), float((out - ref).abs().max())
        assert torch.equal(out, again)
    assert i8.launch_count() == n0 + 4
    r1 = i8.route_launches()
    assert r1["wgmma"] == r0["wgmma"] + 4 and r1["mma_sync"] == r0["mma_sync"]


def test_cuda_int8_dense_wgmma_and_mma_sync_products_agree():
    """On one prefill call the two product kernels (``product(route=)``,
    the diagnostic entry) give the plain version's bits, split or not."""
    dev = _need_cuda()
    for m, o, u in ((256, 1024, 4096), (1024, 4096, 4096), (130, 1000, 4096)):
        x, w, s, b = _int8_inputs(m, o, u, dev, seed=o)
        xq, sx = i8.quantize_rows(x)
        ref = i8.int8_dense_torch(x, w, s, b)
        for route in ("wgmma", "mma_sync"):  # the decode kernel takes M <= 32
            assert torch.equal(i8.product(xq, sx, u, w, s, b, route=route),
                               ref), route


def test_cuda_int8_dense_misaligned_weight_at_prefill_takes_mma_sync():
    """A weight off a 16-byte boundary, or with rows not a multiple of 16
    bytes, at M = 256 runs the ``mma.sync`` kernel and still gives the
    plain version's bits."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(256, 1024, 4096, dev, seed=21)
    wm = _misaligned(w)
    xr, wr, sr, br = _int8_inputs(256, 64, 4100, dev, seed=22)
    for args in ((x, wm, s, b), (xr, wr, sr, br)):
        assert not i8.takes_wgmma(256, args[1].shape[1], args[1].data_ptr())
        r0 = i8.route_launches()
        out = i8.int8_dense(*args)
        r1 = i8.route_launches()
        assert r1["mma_sync"] == r0["mma_sync"] + 1
        assert r1["wgmma"] == r0["wgmma"]
        assert torch.equal(out, i8.int8_dense_torch(*args))


def test_cuda_int8_dense_wgmma_replays_in_a_cuda_graph():
    """A prefill call on the wgmma kernel (its tensor maps encoded on the
    host and passed by value) captured in a graph records one launch and
    replays after x changes in place with the plain version's bits."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(256, 1024, 4096, dev, seed=31)
    assert i8.takes_wgmma(256, 4096, w.data_ptr())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        i8.int8_dense(x, w, s, b)  # warm: builds the library, sizes the pool
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0, c0 = i8.launch_count(), i8.captured_count()
    with torch.cuda.graph(graph):
        out = i8.int8_dense(x, w, s, b)
    assert i8.captured_count() == c0 + 1 and i8.launch_count() == n0
    for seed in (32, 33, 34):
        x.copy_(_int8_inputs(256, 1024, 4096, dev, seed=seed)[0])
        graph.replay()
        i8.count_replays(1)
        torch.cuda.synchronize()
        assert torch.equal(out, i8.int8_dense_torch(x, w, s, b))
    assert i8.launch_count() == n0 + 3


# -- the int8 product's decode rows on the decode kernel -----------------------

# Llama-3-8B's projections at decode, (O, U): q and o, k and v, gate and up,
# down, and the head
DECODE_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                 (128256, 4096)]
_DEVICE_WEIGHT = {}


def _device_int8_weight(o, u, dev):
    """A seeded int8 weight (O, U) with per-channel scales and a bias, made
    on the card; the last one is kept for the next test (the head's is
    525 MB)."""
    key = (o, u, dev.index)
    if key not in _DEVICE_WEIGHT:
        _DEVICE_WEIGHT.clear()
        gen = torch.Generator(device=dev).manual_seed(o + u)
        w = torch.randint(-127, 128, (o, u), dtype=torch.int8, device=dev,
                          generator=gen)
        s = torch.rand(o, device=dev, generator=gen) * 9e-3 + 1e-3
        b = torch.randn(o, device=dev, generator=gen)
        _DEVICE_WEIGHT[key] = (w, s, b)
    return _DEVICE_WEIGHT[key]


def _decode_x(m, u, dev, seed):
    """Normal activations with a row of zeros and a row of exact .5 ties
    (amax 127, so sx = 1) where M >= 3."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, u, device=dev, generator=gen)
    if m >= 3:
        x[1] = 0.0
        x[2] = 0.0
        x[2, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5],
                                device=dev)
    return x


@pytest.mark.parametrize("m", [1, 4, 17, 20, 32])
@pytest.mark.parametrize("o,u", DECODE_SHAPES)
def test_cuda_int8_dense_decode_matches_plain_bitwise(m, o, u):
    """Decode and verify rows on an aligned weight take the decode kernel
    (K1, K2d and, where the plan splits U, K3, chained by programmatic
    dependent launch), which equals the plain version bit for bit with and
    without a bias; two calls repeat bit for bit; one launch a call."""
    dev = _need_cuda()
    w, s, b = _device_int8_weight(o, u, dev)
    x = _decode_x(m, u, dev, seed=m + o)
    assert i8.route_for(m, u, w.data_ptr()) == "decode"
    n0, r0 = i8.launch_count(), i8.route_launches()
    for bias in (None, b):
        out = i8.int8_dense(x, w, s, bias)
        again = i8.int8_dense(x, w, s, bias)
        ref = i8.int8_dense_torch(x, w, s, bias)
        assert torch.equal(out, ref), float((out - ref).abs().max())
        assert torch.equal(out, again)
    assert i8.launch_count() == n0 + 4
    r1 = i8.route_launches()
    assert {k: r1[k] - r0[k] for k in r1} == {"wgmma": 0, "decode": 4,
                                               "mma_sync": 0}


@pytest.mark.parametrize("m", [1, 4, 20, 32])
@pytest.mark.parametrize("o,u", DECODE_SHAPES[:4] + [(1000, 4096), (96, 208)])
def test_cuda_int8_dense_decode_and_mma_sync_products_agree(m, o, u):
    """On one call's xq the decode kernel's product and the ``mma.sync``
    tile kernel's product give the same bits, the plain version's (O = 1000
    leaves a ragged last block of channels, U = 208 a partial chunk)."""
    dev = _need_cuda()
    w, s, b = _device_int8_weight(o, u, dev)
    x = _decode_x(m, u, dev, seed=7 * m + u)
    xq, sx = i8.quantize_rows(x)
    ref = i8.int8_dense_torch(x, w, s, b)
    for route in ("decode", "mma_sync"):
        assert torch.equal(i8.product(xq, sx, u, w, s, b, route=route),
                           ref), route


@pytest.mark.parametrize("m", [1, 4, 1024])
@pytest.mark.parametrize("u", [30, 4096, 14336, 70000])
def test_cuda_int8_quantize_rows_matches_plain_with_zero_and_tie_rows(m, u):
    """The row quantization (a cluster of blocks a row, the row read once
    into registers; past 8 blocks' registers, read twice) gives the plain
    version's xq and sx, zero rows and .5 ties included, zeros from U to
    the padded width, on an aligned and on a misaligned x."""
    dev = _need_cuda()
    x = _decode_x(m, u, dev, seed=u + m)
    pq, psx = i8.quantize_rows_torch(x)
    for xin in (x, _misaligned(x)):
        xq, sx = i8.quantize_rows(xin)
        assert xq.shape == (m, i8.padded_u(u))
        assert torch.equal(xq[:, :u], pq) and torch.equal(sx, psx[:, 0])
        assert not xq[:, u:].any()
    if m >= 3:
        assert sx[1].item() == np.float32(1e-8) and sx[2].item() == 1.0
        assert xq[2, :6].tolist() == [127, 2, -4, 0, 0, 2]


def test_cuda_int8_dense_decode_chained_calls_without_a_sync():
    """Calls that each read the one before's output, issued back to back
    with no sync (as a layer's projections run), give the plain chain's
    bits: each quantization waits for the product before it although the
    products start early under programmatic dependent launch."""
    dev = _need_cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    weights = []
    for o, u in ((1024, 4096), (14336, 1024), (4096, 14336), (4096, 4096)):
        w = torch.randint(-127, 128, (o, u), dtype=torch.int8, device=dev,
                          generator=gen)
        s = torch.rand(o, device=dev, generator=gen) * 1e-3 + 1e-4
        weights.append((w, s))
    x = torch.randn(4, 4096, device=dev, generator=gen)
    h, ref = x, x
    for w, s in weights:
        assert i8.route_for(4, w.shape[1], w.data_ptr()) == "decode"
        h = i8.int8_dense(h, w, s)
        ref = i8.int8_dense_torch(ref, w, s)
    torch.cuda.synchronize()
    assert torch.equal(h, ref)


@pytest.mark.parametrize("o,u", [(1024, 4096), (14336, 4096)])
def test_cuda_int8_dense_decode_replays_in_a_cuda_graph(o, u):
    """A decode call (the K1 -> K2d -> K3 chain by programmatic dependent
    launch at k/v's split shape, K1 -> K2d at gate/up's unsplit one)
    captured in a CUDA graph records one launch, runs none, and replays
    after x changes in place with the plain version's bits."""
    dev = _need_cuda()
    w, s, b = _device_int8_weight(o, u, dev)
    x = _decode_x(4, u, dev, seed=40)
    assert i8.route_for(4, u, w.data_ptr()) == "decode"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (i8.decode_plan(4, o, u, sms).slices > 1) == (o == 1024)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        i8.int8_dense(x, w, s, b)  # warm: builds the library, sizes the pool
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0, c0 = i8.launch_count(), i8.captured_count()
    with torch.cuda.graph(graph):
        out = i8.int8_dense(x, w, s, b)
    assert i8.captured_count() == c0 + 1 and i8.launch_count() == n0
    for seed in (41, 42, 43):
        x.copy_(_decode_x(4, u, dev, seed=seed))
        graph.replay()
        i8.count_replays(1)
        torch.cuda.synchronize()
        assert torch.equal(out, i8.int8_dense_torch(x, w, s, b))
    assert i8.launch_count() == n0 + 3


def test_cuda_int8_dense_row_launches_count_eager_calls_by_kernel_and_rows():
    """Each eager call adds one to its (kernel, rows M) pair of
    ``row_launches``, on every route; calls captured into a graph add
    none."""
    dev = _need_cuda()
    i8.reset_launch_count()
    calls = [(4, 1024, 4096, False), (4, 1024, 4096, False),
             (20, 1024, 4096, False), (64, 1024, 4096, False),
             (4, 1024, 4096, True)]
    for m, o, u, misaligned in calls:
        x, w, s, b = _int8_inputs(m, o, u, dev, seed=m + 30)
        i8.int8_dense(x, _misaligned(w) if misaligned else w, s, b)
    assert i8.row_launches() == {("decode", 4): 2, ("decode", 20): 1,
                                 ("wgmma", 64): 1, ("mma_sync", 4): 1}
    assert sum(i8.row_launches().values()) == sum(
        i8.route_launches().values()) == i8.launch_count()
    x, w, s, b = _int8_inputs(4, 1024, 4096, dev, seed=35)
    i8.int8_dense(x, w, s, b)  # warm on the stream before capture
    torch.cuda.synchronize()
    before = i8.row_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        i8.int8_dense(x, w, s, b)
    graph.replay()
    torch.cuda.synchronize()
    assert i8.row_launches() == before


def test_cuda_int8_dense_misaligned_weight_at_decode_takes_mma_sync():
    """A weight off a 16-byte boundary, or with rows not a multiple of 16
    bytes, at M = 4 runs the ``mma.sync`` kernel and gives the plain
    version's bits."""
    dev = _need_cuda()
    x, w, s, b = _int8_inputs(4, 1024, 4096, dev, seed=23)
    xr, wr, sr, br = _int8_inputs(4, 64, 4100, dev, seed=24)
    for args in ((x, _misaligned(w), s, b), (xr, wr, sr, br)):
        assert i8.route_for(4, args[1].shape[1],
                            args[1].data_ptr()) == "mma_sync"
        r0 = i8.route_launches()
        out = i8.int8_dense(*args)
        r1 = i8.route_launches()
        assert {k: r1[k] - r0[k] for k in r1} == {"wgmma": 0, "decode": 0,
                                                   "mma_sync": 1}
        assert torch.equal(out, i8.int8_dense_torch(*args))


# ---------------------------------------------------------------------------
# The strict baseline rung's shape-stable kernels (ops.hopper.stable_ops):
# each against its plain version within STABLE_REL of the largest |output|
# (the same f32 sums in another order), bit for bit across repeats, across
# S1's instantiations and across the rows that share a call
# ---------------------------------------------------------------------------

STABLE_REL = 1e-5
# (M, O, U, bias): Llama-3-8B's projections at decode (4), verify (20) and
# prefill (1024) rows, a ragged U, a bias
STABLE_DENSE_CASES = [(4, 1024, 4096, False), (1, 4096, 4096, False),
                      (4, 14336, 4096, False), (4, 4096, 14336, False),
                      (20, 4096, 4096, False), (1024, 1024, 4096, False),
                      (3, 37, 30, True), (40, 100, 1001, True)]


def _stable_close(out, ref):
    err = float((out - ref).abs().max())
    assert err <= STABLE_REL * float(ref.abs().max()), err


def _dense_inputs(m, o, u, bias, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, u, device=dev, generator=g)
    w = (torch.rand(o, u, device=dev, generator=g) - 0.5) * 0.14
    b = torch.randn(o, device=dev, generator=g) if bias else None
    return x, w, b


@pytest.mark.parametrize("case", STABLE_DENSE_CASES,
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_cuda_stable_dense_matches_plain(case):
    """S1 against ``stable_dense_torch``, aligned and on a misaligned copy
    of x and w (scalar loads: the same bits), and two calls bit for bit;
    each call counts one launch at its rows."""
    dev = _need_cuda()
    m, o, u, bias = case
    x, w, b = _dense_inputs(m, o, u, bias, dev)
    st.reset_launch_count()
    out = st.stable_dense(x, w, b)
    assert st.last_path() == "cuda"
    assert st.launch_count()["dense"] == 1
    assert st.row_launches() == {("dense", m): 1}
    _stable_close(out, st.stable_dense_torch(x, w, b))
    assert torch.equal(st.stable_dense(x, w, b), out)
    assert torch.equal(st.stable_dense(_misaligned(x), _misaligned(w), b),
                       out)


@pytest.mark.parametrize("u", [4096, 1001])
def test_cuda_stable_dense_instantiations_agree_bitwise(u):
    """Every S1 instantiation (decode tiles of 1, 4 and 8 rows by 1 or 2
    channels, the prefill 8 x 8 tile) gives every output the same bits."""
    dev = _need_cuda()
    x, w, _ = _dense_inputs(24, 300, u, False, dev, seed=1)
    outs = [st.dense_launch(x, w, tile=i) for i in range(len(st.DENSE_TILES))]
    for i, out in enumerate(outs[1:], 1):
        assert torch.equal(out, outs[0]), st.DENSE_TILES[i]


@pytest.mark.parametrize("ou", [(1024, 4096), (4096, 14336), (14336, 4096)],
                         ids=["kv", "down", "gate"])
def test_cuda_stable_dense_row_invariant_at_llama_shapes(ou):
    """Rows at M = 1 and 4 (decode tiles) equal, bit for bit, the same rows
    inside an M = 1024 call (the prefill tile) at its first, middle and
    last places."""
    dev = _need_cuda()
    o, u = ou
    x, w, _ = _dense_inputs(1024, o, u, False, dev, seed=2)
    full = st.stable_dense(x, w)
    for r0, m in ((0, 1), (0, 4), (510, 4), (1020, 4), (1023, 1)):
        assert torch.equal(st.stable_dense(x[r0:r0 + m], w),
                           full[r0:r0 + m]), (r0, m)


def _other_dense_tiles():
    return [i for i in range(len(st.DENSE_TILES)) if i != st.PREFILL_TILE]


# (M, O, U): prefill rows at Llama-3-8B's q/o, k/v, gate/up and down
# shapes, at the engine's chunk (256) and a 4 x 256 prefill (1024)
STABLE_PREFILL_CASES = [(256, 4096, 4096), (1024, 1024, 4096),
                        (256, 14336, 4096), (1024, 4096, 14336)]


@pytest.mark.parametrize("case", STABLE_PREFILL_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_cuda_stable_dense_prefill_tile_bitwise(case):
    """The ring-fed prefill tile (the plan's pick above DECODE_ROWS) gives
    every output the bits of every other S1 instantiation, the first
    prefill tile (global loads) and the decode tiles included, at prefill
    rows of Llama-3-8B's projections."""
    dev = _need_cuda()
    m, o, u = case
    assert st.dense_plan(m, o, torch.cuda.get_device_properties(
        dev).multi_processor_count) == st.PREFILL_TILE
    x, w, _ = _dense_inputs(m, o, u, False, dev, seed=5)
    new = st.dense_launch(x, w, tile=st.PREFILL_TILE)
    for i in _other_dense_tiles():
        assert torch.equal(st.dense_launch(x, w, tile=i), new), i


@pytest.mark.parametrize("case", [(1000, 37, 4095, True),
                                  (33, 100, 1001, False),
                                  (300, 200, 130, True)],
                         ids=["1000x37x4095", "33x100x1001", "300x200x130"])
def test_cuda_stable_dense_prefill_tile_ragged_and_misaligned(case):
    """Ragged M, O and U (a partial last chunk, U % 4 != 0: 4-byte copies)
    and misaligned x and w: the ring-fed tile equals every other
    instantiation bit for bit, and the plain version within STABLE_REL."""
    dev = _need_cuda()
    m, o, u, bias = case
    x, w, b = _dense_inputs(m, o, u, bias, dev, seed=6)
    new = st.dense_launch(x, w, b, tile=st.PREFILL_TILE)
    _stable_close(new, st.stable_dense_torch(x, w, b))
    assert torch.equal(st.dense_launch(_misaligned(x), _misaligned(w), b,
                                       tile=st.PREFILL_TILE), new)
    for i in _other_dense_tiles():
        assert torch.equal(st.dense_launch(x, w, b, tile=i), new), i


# (B, H, KV, T, S, D, start_pos): Llama-3-8B's prefill from position 0 and
# a T = 8 chunk from mid-ring, MHA at D = 30, D = 256 near the ring's end,
# a group of 16 heads, rows past the ring's end
STABLE_ROWS_CASES = [
    (4, 32, 8, 256, 1024, 128, [0, 0, 0, 0]),
    (4, 32, 8, 8, 1024, 128, [100, 517, 1000, 3]),
    (2, 6, 6, 37, 70, 30, [0, 40]),
    (2, 8, 2, 5, 333, 256, [100, 328]),
    (1, 16, 1, 12, 200, 64, [50]),
    (2, 4, 2, 40, 64, 128, [30, 0]),
]


@pytest.mark.parametrize("case", STABLE_ROWS_CASES,
                         ids=["prefill", "mid_ring_t8", "mha_d30", "d256",
                              "g16", "past_ring"])
def test_cuda_stable_attention_rows_equal_heads_bitwise(case):
    """S2's rows kernel (T > 1) equals the heads kernel (a block a query
    time) bit for bit on every row, aligned and misaligned, and its plain
    version within STABLE_REL."""
    dev = _need_cuda()
    b, h, kv, t, s, d, sp = case
    q, k, v = _attention_inputs(b, h, kv, t, s, d, dev, seed=7)
    sp = torch.tensor(sp, dtype=torch.int32, device=dev)
    sc = 1.0 / d ** 0.5
    rows = st.attention_launch(q, k, v, sp, sc, route="rows")
    heads = st.attention_launch(q, k, v, sp, sc, route="heads")
    assert torch.equal(rows, heads)
    assert torch.equal(
        st.attention_launch(_misaligned(q), _misaligned(k), _misaligned(v),
                            sp, sc, route="rows"), rows)
    _stable_close(rows, st.stable_attention_torch(q, k, v, sp, sc))


def test_cuda_stable_kernels_do_not_spill():
    """No S1, S2 or S3 instantiation keeps local (spilled) memory: every
    S1 tile (the prefill tile's aligned and unaligned kernels), S2's heads,
    rows and decode kernels, S3's two kernels."""
    _need_cuda()
    attrs = st.kernel_attributes()
    want = ({f"dense_t{i}" for i in range(len(st.DENSE_TILES))}
            | {f"dense_t{st.PREFILL_TILE}_unaligned", "attention_rows_nd1",
               "attention_rows_nd2", "attention_nd1", "norm",
               "attention_decode", "norm_staged"})
    assert want <= set(attrs), sorted(want - set(attrs))
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)


def _attention_inputs(b, h, kv, t, s, d, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, t, d, device=dev, generator=g)
    k = torch.randn(b, kv, s, d, device=dev, generator=g)
    v = torch.randn(b, kv, s, d, device=dev, generator=g)
    return q, k, v


# (B, H, KV, T, S, D, start_pos): Llama-3-8B's decode and prefill, MHA, a
# ragged D, D = 256, positions past the ring's end
STABLE_ATTN_CASES = [
    (4, 32, 8, 1, 1024, 128, [0, 16, 300, 1023]),
    (4, 32, 8, 256, 1024, 128, [0, 0, 0, 0]),
    (2, 6, 6, 3, 70, 30, [0, 40]),
    (2, 8, 2, 5, 333, 256, [100, 330]),
]


@pytest.mark.parametrize("case", STABLE_ATTN_CASES,
                         ids=["decode", "prefill", "mha_d30", "d256"])
def test_cuda_stable_attention_matches_plain(case):
    """S2 against ``stable_attention_torch`` and two calls bit for bit;
    one launch counted at its T."""
    dev = _need_cuda()
    b, h, kv, t, s, d, sp = case
    q, k, v = _attention_inputs(b, h, kv, t, s, d, dev)
    sp = torch.tensor(sp, dtype=torch.int32, device=dev)
    st.reset_launch_count()
    out = st.stable_attention(q, k, v, sp)
    assert st.last_path() == "cuda"
    assert st.row_launches() == {("attention", t): 1}
    _stable_close(out, st.stable_attention_torch(q, k, v, sp))
    assert torch.equal(st.stable_attention(q, k, v, sp), out)
    assert torch.equal(
        st.stable_attention(_misaligned(q), _misaligned(k), _misaligned(v),
                            sp), out)


def test_cuda_stable_attention_row_invariant_at_llama_shapes():
    """A T = 1 query at position p equals, bit for bit, the same query row
    inside a T = 256 prefill from position 0 over the same ring (first,
    middle and last rows)."""
    dev = _need_cuda()
    q, k, v = _attention_inputs(4, 32, 8, 256, 1024, 128, dev, seed=3)
    zero = torch.zeros(4, dtype=torch.int32, device=dev)
    full = st.stable_attention(q, k, v, zero)
    for t in (0, 17, 128, 255):
        one = st.stable_attention(q[:, :, t:t + 1].contiguous(), k, v,
                                  zero + t)
        assert torch.equal(one, full[:, :, t:t + 1]), t


def test_cuda_stable_rms_norm_matches_plain_and_row_invariant():
    """S3 against ``stable_rms_norm_torch`` on rows of 4096 (aligned and
    misaligned: the same bits) and a ragged 4095; 4 rows equal the same
    rows inside a 1024-row call bit for bit."""
    dev = _need_cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    for n in (4096, 4095):
        x = torch.randn(1024, n, device=dev, generator=g)
        gamma = torch.rand(n, device=dev, generator=g) + 0.5
        st.reset_launch_count()
        full = st.stable_rms_norm(x, gamma, 1e-5)
        assert st.row_launches() == {("norm", 1024): 1}
        _stable_close(full, st.stable_rms_norm_torch(x, gamma, 1e-5))
        assert torch.equal(st.stable_rms_norm(x, gamma, 1e-5), full)
        assert torch.equal(st.stable_rms_norm(_misaligned(x), gamma, 1e-5),
                           full)
        for r0 in (0, 510, 1020):
            assert torch.equal(st.stable_rms_norm(x[r0:r0 + 4], gamma, 1e-5),
                               full[r0:r0 + 4]), (n, r0)


# (B, H, KV, S, D, start_pos) at T = 1: STABLE_ATTN_CASES' decode case,
# phase 3c's positions (the middle of a 32-token generate), a full ring
# (positions 1000-1023), one live position and none (NaN), MHA at D = 30,
# D = 256, a group of 16 heads (two clusters a KV head) and a short ring
STABLE_DECODE_CASES = [
    (4, 32, 8, 1024, 128, [0, 16, 300, 1023]),
    (4, 32, 8, 1024, 128, [33, 80, 146, 266]),
    (4, 32, 8, 1024, 128, [1000, 1007, 1016, 1023]),
    (2, 32, 8, 1024, 128, [0, -1]),
    (2, 6, 6, 70, 30, [0, 40]),
    (2, 8, 2, 333, 256, [100, 330]),
    (1, 16, 1, 200, 64, [150]),
    (3, 4, 2, 64, 128, [5, 63, 200]),
]


@pytest.mark.parametrize("case", STABLE_DECODE_CASES,
                         ids=["decode", "phase3c", "full_ring", "n1_and_none",
                              "mha_d30", "d256", "g16", "short_ring"])
def test_cuda_stable_attention_decode_equals_heads_bitwise(case):
    """S2's decode kernel (T = 1, the route's pick) equals the heads kernel
    bit for bit on every row at every cluster size that fits (1, 2, 4 and
    8 blocks), aligned and on misaligned rings (4-byte copies); no live
    position gives the heads kernel's NaN; the plain version within
    STABLE_REL where a position is live."""
    dev = _need_cuda()
    b, h, kv, s, d, sp = case
    q, k, v = _attention_inputs(b, h, kv, 1, s, d, dev, seed=8)
    sp = torch.tensor(sp, dtype=torch.int32, device=dev)
    sc = 1.0 / d ** 0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert st.attention_route(b, h, kv, 1, s, d, sms) == "decode"
    heads = st.attention_launch(q, k, v, sp, sc, route="heads")
    gb = min(h // kv, 8)
    for cluster in (1, 2, 4, 8):
        if st.attention_decode_smem_bytes(s, d, cluster, gb) > 231424:
            continue
        out = st.attention_launch(q, k, v, sp, sc, route="decode",
                                  cluster=cluster)
        assert _same_bits(out, heads), cluster
    assert _same_bits(st.attention_launch(
        _misaligned(q), _misaligned(k), _misaligned(v), sp, sc,
        route="decode"), heads)
    live = sp >= 0
    assert bool(torch.isnan(heads[~live]).all())
    _stable_close(heads[live], st.stable_attention_torch(q, k, v, sp,
                                                         sc)[live])


def test_cuda_stable_attention_decode_counts_and_t_above_one():
    """``stable_attention`` at T = 1 launches the decode kernel (counted
    under its route); the decode kernel run at T > 1 (a cluster a query
    time) equals the heads kernel bit for bit too."""
    dev = _need_cuda()
    q, k, v = _attention_inputs(4, 32, 8, 1, 1024, 128, dev, seed=9)
    sp = torch.tensor([33, 80, 146, 266], dtype=torch.int32, device=dev)
    st.reset_launch_count()
    out = st.stable_attention(q, k, v, sp)
    assert st.route_launches() == {"decode": 1}
    assert torch.equal(out, st.attention_launch(q, k, v, sp, 128 ** -0.5,
                                                route="heads"))
    q, k, v = _attention_inputs(2, 8, 2, 7, 100, 64, dev, seed=10)
    sp = torch.tensor([0, 90], dtype=torch.int32, device=dev)
    assert torch.equal(
        st.attention_launch(q, k, v, sp, 0.125, route="decode"),
        st.attention_launch(q, k, v, sp, 0.125, route="heads"))


@pytest.mark.parametrize("mn", [(4, 4096), (1024, 4096), (4095, 4095),
                                (5, 30)],
                         ids=["decode", "prefill", "ragged", "short"])
def test_cuda_stable_rms_norm_staged_equals_warp_bitwise(mn):
    """S3's staged kernel (the plan's pick) equals the warp-a-row kernel bit
    for bit at decode's 4 rows, a prefill's 1024, a ragged 4095 x 4095 and
    short rows, at every rows-a-block from 1 to 8 and on a misaligned x
    (4-byte copies, scalar stores); ``stable_rms_norm`` counts it under
    ``"staged"``."""
    dev = _need_cuda()
    m, n = mn
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(m, n, device=dev, generator=g)
    gamma = torch.rand(n, device=dev, generator=g) + 0.5
    ref = st.norm_launch(x, gamma, 1e-5, "warp")
    for rows in range(1, 9):
        assert torch.equal(st.norm_launch(x, gamma, 1e-5, "staged",
                                          rows=rows), ref), rows
    assert torch.equal(st.norm_launch(_misaligned(x), gamma, 1e-5,
                                      "staged"), ref)
    st.reset_launch_count()
    assert torch.equal(st.stable_rms_norm(x, gamma, 1e-5), ref)
    assert st.norm_route_launches() == {"staged": 1}
    _stable_close(ref, st.stable_rms_norm_torch(x, gamma, 1e-5))


def test_cuda_stable_refusals_and_forced_paths():
    """The wrappers raise for what the kernels do not take (non-f32, an
    oversized ring, mismatched heads) and, under ``force_path("cuda")``,
    for CPU tensors; ``force_path("torch")`` takes the plain versions on
    the card and counts nothing."""
    dev = _need_cuda()
    x, w, _ = _dense_inputs(4, 64, 128, False, dev)
    with pytest.raises(MXNetError, match="float32"):
        st.stable_dense(x.double(), w.double())
    q, k, v = _attention_inputs(1, 4, 3, 1, 16, 8, dev)
    sp = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(MXNetError, match="multiple of KV"):
        st.stable_attention(q, k, v, sp)
    q, k, v = _attention_inputs(1, 8, 1, 1, 40000, 128, dev)
    with pytest.raises(MXNetError, match="shared memory"):
        st.stable_attention(q, k, v, sp)
    st.force_path("cuda")
    try:
        with pytest.raises(MXNetError, match="force_path"):
            st.stable_dense(x.cpu(), w.cpu())
        with pytest.raises(MXNetError, match="force_path"):
            st.stable_rms_norm(x.cpu(), torch.ones(128))
        with pytest.raises(MXNetError, match="force_path"):
            st.stable_attention(q.cpu(), k.cpu(), v.cpu(), sp.cpu())
    finally:
        st.force_path(None)
    st.reset_launch_count()
    st.force_path("torch")
    try:
        out = st.stable_dense(x, w)
        assert st.last_path() == "torch"
    finally:
        st.force_path(None)
    assert st.launch_count() == {"dense": 0, "attention": 0, "norm": 0}
    _stable_close(st.stable_dense(x, w), out)


def test_cuda_baseline_generator_decode_equals_prefill():
    """``Generator(decode_path="baseline")`` at ``llama_serve_12l_test``
    width on the card: each of 16 decode steps' logits bit for bit a fresh
    full prefill's, with every layer launching S1 7 times (and the head
    once), S2 (the decode kernel at T = 1) and S3 (staged; 2 a layer and
    the final norm) a forward; the multi-
    step generator (a CUDA graph) gives the same greedy tokens and counts
    its replays' launches."""
    dev = _need_cuda()
    trandom.seed(0)
    model = get_llama("llama_serve_12l_test", device=dev)
    layers = len(model._blocks)
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(32,),
              decode_path="baseline")
    gen = Generator(model, **kw)
    prompts = [[5, 9, 200, 31, 7], [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]]
    toks = np.zeros((2, 32), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    logits, cache = gen.prefill(toks, lens, KVCache.alloc(model, 2, 64))
    seqs = [list(p) for p in prompts]
    st.reset_launch_count()
    for _ in range(16):
        ids = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i in range(2):
            seqs[i].append(int(ids[i]))
        logits, cache = gen.decode_step(
            ids, np.array([len(s_) - 1 for s_ in seqs], np.int32), cache)
        ref_toks = np.zeros((2, 32), np.int32)
        for i, s_ in enumerate(seqs):
            ref_toks[i, :len(s_)] = s_
        ref, _ = gen.prefill(ref_toks, np.array([len(s_) for s_ in seqs],
                                                np.int32),
                             KVCache.alloc(model, 2, 64))
        assert torch.equal(logits, ref)
    assert st.launch_count() == {"dense": 32 * (7 * layers + 1),
                                 "attention": 32 * layers,
                                 "norm": 32 * (2 * layers + 1)}
    # the decode steps on the decode kernel, every norm staged
    routes = st.route_launches()
    assert routes["decode"] == 16 * layers
    assert sum(routes.values()) == 32 * layers
    assert st.norm_route_launches() == {"staged": 32 * (2 * layers + 1)}
    want, _ = gen.generate(prompts, max_new_tokens=12)
    multi = Generator(model, multistep=True, decode_steps=4, **kw)
    multi.warmup()
    n0 = st.launch_count()["dense"]
    out, info = multi.generate(prompts, max_new_tokens=12)
    multi.assert_no_recompiles()
    assert out == want
    assert st.launch_count()["dense"] - n0 == (
        (7 * layers + 1) * (1 + 4 * info["decode_visits"]))
