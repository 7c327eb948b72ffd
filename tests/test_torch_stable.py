"""The strict ``baseline`` serving rung of the port on the CPU.

Three parts:

* the plain versions of ``ops/hopper/stable_ops`` (``stable_dense_torch``,
  ``stable_attention_torch``, ``stable_rms_norm_torch``) against the JAX
  ops ``stable_dense``, ``cached_attention(path="baseline")`` and
  ``rms_norm`` on the same numpy inputs, to 1e-5 of the largest |output|
  (the same f32 formulas; the frameworks order their sums differently),
  and their row invariance: a row's bits do not depend on how many rows
  share the call;
* the port's baseline cache path against the JAX model's eager cache path
  over a JAX ``KVCache`` (whose ``path`` is ``"baseline"``), driven by
  hand: a prefill, then 16 greedy decode steps, logits to 1e-4 of their
  largest |value| and the greedy tokens equal. (The JAX
  ``Generator(decode_path="baseline")`` itself does not run on the
  installed JAX: its compiler options are refused.)
* the rung's contract inside the port: each decode step's logits bit for
  bit a full prefill's (the port of ``tests/test_serve.py``'s parity
  tests), paged decode bit for bit ring decode, the prefix cache, multi-
  step N = 8 and N = 1 tokens equal single-step, and the
  ``ContinuousEngine``'s and ``SpeculativeGenerator``'s tokens equal the
  baseline ``Generator``'s. ``MXNET_SERVE_STRICT_PARITY=1`` pins every
  entry point to the rung.

On the card the kernels carry the same contract
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3c and
``serve baseline``). Inputs come from numpy with a seed; weights from the
JAX model through ``load_reference_params``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy as mnp
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.serve import KVCache as JaxKVCache
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.hopper import stable_ops as st
from mxnet_tpu_torch.serve import (ContinuousEngine, Generator, KVCache,
                                   SpeculativeGenerator)

REL = 1e-5        # plain versions against the JAX ops, of max |output|
LOGIT_REL = 1e-4  # the cache path against the JAX eager cache path
WAIT = 60         # seconds any one engine future may take

_MODELS = {}


def _models(config):
    """(JAX model, port model with its weights, vocab)."""
    if config not in _MODELS:
        mx.random.seed(0)
        net = jax_get_llama(config)
        net.initialize()
        params = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        port = load_reference_params(get_llama(config, device="cpu"), params)
        _MODELS[config] = (net, port, params["embed.weight"].shape[0])
    return _MODELS[config]


def _prompts(vocab, seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=n)] for n in lens]


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# the plain versions against the JAX ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead,o,u,bias", [
    ((2, 3), 24, 16, False),   # a (B, T) block
    ((5,), 11, 37, True),      # ragged U, with a bias
    ((1, 1), 512, 128, False),  # a decode row against a vocabulary
], ids=["block", "ragged_bias", "decode_head"])
def test_stable_dense_plain_matches_jax(lead, o, u, bias):
    rng = np.random.RandomState(1)
    x = rng.randn(*lead, u).astype(np.float32)
    w = rng.uniform(-0.07, 0.07, size=(o, u)).astype(np.float32)
    b = rng.randn(o).astype(np.float32) if bias else None
    ref = jops.stable_dense(mnp.array(x), mnp.array(w),
                            None if b is None else mnp.array(b)).asnumpy()
    out = tops.stable_dense(torch.from_numpy(x), torch.from_numpy(w),
                            None if b is None else torch.from_numpy(b))
    assert st.last_path() == "torch"
    _close(out.numpy(), ref)


@pytest.mark.parametrize("b,h,kv,t,s,d,sp", [
    (2, 4, 2, 1, 24, 16, [0, 17]),     # GQA decode rows
    (2, 4, 2, 5, 24, 16, [0, 9]),      # GQA prefill block
    (1, 3, 3, 7, 20, 30, [12]),        # MHA, ragged D, past half the ring
], ids=["gqa_decode", "gqa_block", "mha_ragged_d"])
def test_stable_attention_plain_matches_jax(b, h, kv, t, s, d, sp):
    """The plain S2 over unexpanded rings equals the JAX op over the
    rings the JAX cache path gives it (K/V heads repeated)."""
    rng = np.random.RandomState(2)
    q = rng.randn(b, h, t, d).astype(np.float32)
    k = rng.randn(b, kv, s, d).astype(np.float32)
    v = rng.randn(b, kv, s, d).astype(np.float32)
    sp = np.array(sp, np.int32)
    rep = h // kv
    ref = jops.cached_attention(
        mnp.array(q), mnp.array(np.repeat(k, rep, axis=1)),
        mnp.array(np.repeat(v, rep, axis=1)), mnp.array(sp)).asnumpy()
    out = st.stable_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(sp))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("rows,n", [(3, 64), (4, 4096), (2, 30)],
                         ids=["small", "llama_row", "ragged"])
def test_stable_rms_norm_plain_matches_jax(rows, n):
    rng = np.random.RandomState(3)
    x = rng.randn(rows, n).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    ref = jops.rms_norm(mnp.array(x), mnp.array(g), eps=1e-5).asnumpy()
    out = tops.stable_rms_norm(torch.from_numpy(x), torch.from_numpy(g),
                               eps=1e-5)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("op", ["dense", "attention", "norm"])
def test_plain_versions_row_invariant(op):
    """A row's bits do not depend on the rows beside it: M = 1 and 4 rows
    (dense, norm) and a T = 1 query (attention) against the same rows
    inside a larger call, at its first, middle and last places."""
    rng = np.random.RandomState(4)
    if op == "dense":
        x = torch.from_numpy(rng.randn(64, 96).astype(np.float32))
        w = torch.from_numpy(rng.randn(200, 96).astype(np.float32))
        full = st.stable_dense_torch(x, w)
        for r0, m in ((0, 1), (30, 4), (60, 4), (63, 1)):
            assert torch.equal(st.stable_dense_torch(x[r0:r0 + m], w),
                               full[r0:r0 + m])
    elif op == "norm":
        x = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
        g = torch.from_numpy(rng.randn(256).astype(np.float32))
        full = st.stable_rms_norm_torch(x, g, 1e-5)
        for r0, m in ((0, 4), (31, 1), (60, 4)):
            assert torch.equal(st.stable_rms_norm_torch(x[r0:r0 + m], g,
                                                        1e-5),
                               full[r0:r0 + m])
    else:
        q = torch.from_numpy(rng.randn(2, 4, 16, 32).astype(np.float32))
        k = torch.from_numpy(rng.randn(2, 2, 40, 32).astype(np.float32))
        v = torch.from_numpy(rng.randn(2, 2, 40, 32).astype(np.float32))
        sp = torch.tensor([0, 20], dtype=torch.int32)
        full = st.stable_attention_torch(q, k, v, sp)
        for t in (0, 7, 15):
            one = st.stable_attention_torch(q[:, :, t:t + 1], k, v, sp + t)
            assert torch.equal(one, full[:, :, t:t + 1])


def test_wrappers_route_by_device_and_count_only_launches():
    """On CPU tensors every wrapper takes its plain version and counts no
    launch; ``force_path("cuda")`` insists on the kernels and raises for
    CPU tensors; ``fusion_fence`` is the identity."""
    st.reset_launch_count()
    x = torch.ones(2, 8)
    w = torch.ones(3, 8)
    sp = torch.zeros(1, dtype=torch.int32)
    q = torch.ones(1, 2, 1, 4)
    calls = (lambda: st.stable_dense(x, w),
             lambda: st.stable_attention(q, q, q, sp),
             lambda: st.stable_rms_norm(x, torch.ones(8)))
    for call in calls:
        call()
        assert st.last_path() == "torch"
    assert st.launch_count() == {"dense": 0, "attention": 0, "norm": 0}
    st.force_path("cuda")
    try:
        for call in calls:
            with pytest.raises(MXNetError, match="force_path"):
                call()
    finally:
        st.force_path(None)
    with pytest.raises(ValueError):
        st.force_path("triton")
    assert tops.fusion_fence(x) is x


def test_plans_follow_shapes_only():
    """S1's instantiation follows M and O (every one gives the same bits);
    S2's block carries one KV head's query heads, at most 8."""
    assert st.dense_plan(1024, 4096, 132) == st.PREFILL_TILE
    assert st.DENSE_TILES[st.dense_plan(4, 1024, 132)] == (4, 1)
    assert st.DENSE_TILES[st.dense_plan(4, 14336, 132)] == (4, 2)
    assert st.DENSE_TILES[st.dense_plan(1, 128256, 132)] == (1, 2)
    assert st.DENSE_TILES[st.dense_plan(20, 4096, 132)] == (8, 1)
    assert st.attention_warps(32, 8) == 4
    assert st.attention_warps(64, 2) == 8
    assert st.attention_smem_bytes(4, 1024, 128) == 4 * (
        2 * 32 * 129 + 2 * 32 * 128 + 4 * 128 + 4 * 1024)


# ---------------------------------------------------------------------------
# the port's baseline cache path against the JAX eager cache path
# ---------------------------------------------------------------------------

def test_baseline_cache_path_matches_jax_eager():
    """llama_tiny_test, two rows of prompt lengths 5 and 8 in an 8-wide
    prefill over a 32-position ring, then 16 greedy decode steps driven by
    hand on both packages' cache paths."""
    net, port, vocab = _models("llama_tiny_test")
    b, s, t = 2, 32, 8
    toks = np.random.RandomState(5).randint(1, vocab, size=(b, t)).astype(
        np.int32)
    lens = np.array([5, 8], np.int32)
    jc = JaxKVCache.alloc(net, b, s)
    assert jc.path == "baseline"
    pc = KVCache.alloc(port, b, s)
    pc.path = "baseline"
    sp = np.zeros(b, np.int32)
    jl = net(mnp.array(toks), cache=jc, start_pos=mnp.array(sp)).asnumpy()
    with torch.no_grad():
        pl = port(torch.from_numpy(toks), cache=pc,
                  start_pos=torch.from_numpy(sp)).numpy()
    _close(pl, jl, LOGIT_REL)
    rows = np.arange(b)
    nxt = jl[rows, lens - 1].argmax(-1)
    assert (pl[rows, lens - 1].argmax(-1) == nxt).all()
    pos = lens.copy()
    for _ in range(16):
        ids = nxt[:, None].astype(np.int32)
        jl = net(mnp.array(ids), cache=jc,
                 start_pos=mnp.array(pos)).asnumpy()[:, 0]
        with torch.no_grad():
            pl = port(torch.from_numpy(ids), cache=pc,
                      start_pos=torch.from_numpy(pos)).numpy()[:, 0]
        _close(pl, jl, LOGIT_REL)
        nxt = jl.argmax(-1)
        assert (pl.argmax(-1) == nxt).all()
        pos = pos + 1


# ---------------------------------------------------------------------------
# the contract inside the port
# ---------------------------------------------------------------------------

def _fresh_prefill(gen, rows, bucket, batch):
    """Logits of a fresh full prefill of ``rows`` (a list of token lists;
    rows past it replay token 1) at ``bucket`` in a new ring."""
    cache = KVCache.alloc(gen.model, batch, gen.max_seq)
    toks = np.zeros((batch, bucket), np.int32)
    lens = np.ones(batch, np.int32)
    toks[:, 0] = 1
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
        lens[i] = len(r)
    return gen.prefill(toks, lens, cache)[0]


def test_decode_matches_full_prefill_bitwise_12l():
    """The port of ``tests/test_serve.py``'s acceptance invariant: 32
    greedy tokens on the 12-layer config, each decode step's logits bit
    for bit those of a full prefill of the whole prefix."""
    _, port, _ = _models("llama_serve_12l_test")
    max_seq = 64
    gen = Generator(port, max_seq=max_seq, batch_buckets=(1,),
                    prompt_buckets=(max_seq,), decode_path="baseline")
    tokens = [3, 141, 59, 26, 5]
    cache = KVCache.alloc(port, 1, max_seq)
    toks = np.zeros((1, max_seq), np.int32)
    toks[0, :len(tokens)] = tokens
    logits, cache = gen.prefill(toks, np.array([len(tokens)], np.int32),
                                cache)
    for step in range(32):
        nxt = int(torch.argmax(logits[0]))
        tokens.append(nxt)
        logits, cache = gen.decode_step(np.array([nxt], np.int32),
                                        np.array([len(tokens) - 1],
                                                 np.int32), cache)
        ref = _fresh_prefill(gen, [tokens], max_seq, 1)
        assert torch.equal(logits, ref), (
            f"step {step}: max |diff| {float((logits - ref).abs().max())}")


def test_batched_mixed_length_decode_parity():
    """The port of ``tests/test_serve.py``'s mixed-length test, bit for
    bit: rows with different prompt lengths share one decode step, and
    each row's logits equal its own full prefill's (the other row a
    one-token prompt)."""
    _, port, _ = _models("llama_tiny_test")
    max_seq = 32
    gen = Generator(port, max_seq=max_seq, batch_buckets=(2,),
                    prompt_buckets=(max_seq,), decode_path="baseline")
    prompts = [[5, 6, 7], [9, 3, 4, 4, 8, 1, 2]]
    outs, _ = gen.generate(prompts, max_new_tokens=4)
    cache = KVCache.alloc(port, 2, max_seq)
    toks = np.zeros((2, max_seq), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    logits, cache = gen.prefill(toks, lens, cache)
    seqs = [list(p) for p in prompts]
    for step in range(4):
        for i in range(2):
            assert int(torch.argmax(logits[i])) == outs[i][step]
            one = [seqs[i]] if i == 0 else [[1], seqs[i]]
            ref = _fresh_prefill(gen, one, max_seq, 2)
            assert torch.equal(logits[i], ref[i])
            seqs[i].append(outs[i][step])
        logits, cache = gen.decode_step(
            np.array([outs[0][step], outs[1][step]], np.int32),
            np.array([len(s) - 1 for s in seqs], np.int32), cache)


def test_paged_decode_equals_ring_bitwise():
    """Paged baseline decode (pages of 8) gives the ring run's logits bit
    for bit at every step, and the same greedy tokens through
    ``generate``."""
    _, port, vocab = _models("llama_serve_12l_test")
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,),
              decode_path="baseline")
    ring = Generator(port, **kw)
    paged = Generator(port, paged=True, page_size=8, **kw)
    prompts = _prompts(vocab, 6, (5, 13))
    toks = np.zeros((2, 16), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    rl, rc = ring.prefill(toks, lens, ring._fresh_cache(2))
    pl, pc = paged.prefill(toks, lens, paged._fresh_cache(2))
    pos = lens.copy()
    for _ in range(12):
        assert torch.equal(rl, pl)
        ids = torch.argmax(rl, dim=-1).to(torch.int32).numpy()
        rl, rc = ring.decode_step(ids, pos, rc)
        pl, pc = paged.decode_step(ids, pos, pc)
        pos = pos + 1
    assert torch.equal(rl, pl)
    assert (ring.generate(prompts, max_new_tokens=10)[0]
            == paged.generate(prompts, max_new_tokens=10)[0])


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_multistep_tokens_equal_single_step(paged):
    """Multi-step baseline decode at N = 8 and N = 1 gives the single-step
    greedy tokens (the super-step runs the same cache path; on the card
    inside a CUDA graph), with 1 + ceil((new - 1) / N) host visits."""
    _, port, vocab = _models("llama_serve_12l_test")
    kw = dict(max_seq=64, batch_buckets=(1, 2), prompt_buckets=(16,),
              decode_path="baseline",
              **({"paged": True, "page_size": 8} if paged else {}))
    prompts = _prompts(vocab, 7, (4, 15))
    want, _ = Generator(port, **kw).generate(prompts, max_new_tokens=20)
    for steps in (8, 1):
        gen = Generator(port, multistep=True, decode_steps=steps, **kw)
        gen.warmup()
        out, info = gen.generate(prompts, max_new_tokens=20)
        gen.assert_no_recompiles()
        assert out == want, steps
        assert info["decode_visits"] == -(-19 // steps)


def test_prefix_cache_keeps_tokens():
    """Two prompts sharing a 16-token prefix through the prefix cache
    (pages of 8): the second pass matches cached pages and gives the ring
    run's tokens."""
    _, port, vocab = _models("llama_tiny_test")
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(32,),
              decode_path="baseline")
    head = _prompts(vocab, 8, (16,))[0]
    prompts = [head + t for t in _prompts(vocab, 9, (5, 11))]
    want, _ = Generator(port, **kw).generate(prompts, max_new_tokens=8)
    gen = Generator(port, prefix_cache=True, page_size=8, **kw)
    for _ in range(2):
        out, _ = gen.generate(prompts, max_new_tokens=8)
        assert out == want
    assert gen.stats()["prefix"][2]["tokens_matched"] > 0


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_engine_tokens_equal_generator(multistep):
    """``ContinuousEngine(decode_path="baseline")``: prompts shorter than,
    equal to and longer than one (1, 16) prefill chunk, decoded in 4
    slots, give the batch-1 baseline ``Generator``'s greedy tokens."""
    _, port, vocab = _models("llama_tiny_test")
    prompts = _prompts(vocab, 10, (3, 16, 20, 37))
    gen = Generator(port, max_seq=64, batch_buckets=(1,),
                    prompt_buckets=(64,), decode_path="baseline")
    want = [gen.generate([p], max_new_tokens=10)[0][0] for p in prompts]
    with ContinuousEngine(port, max_seq=64, num_slots=4, page_size=16,
                          prefill_chunk=16, decode_path="baseline",
                          multistep=multistep, decode_steps=8) as eng:
        futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        got = [f.result(timeout=WAIT)["tokens"] for f in futs]
        eng.assert_no_recompiles()
        assert eng.decode_path == "baseline"
    assert got == want


def test_registry_passes_the_rung_through():
    """``ModelRegistry(decode_path="baseline")`` builds its tenants'
    engines on the rung: a tenant serves the baseline ``Generator``'s
    tokens, and so does its reload after an eviction."""
    from mxnet_tpu_torch.serve import ModelRegistry

    _, port, vocab = _models("llama_tiny_test")
    prompts = _prompts(vocab, 13, (4, 9))
    gen = Generator(port, max_seq=64, batch_buckets=(1,),
                    prompt_buckets=(64,), decode_path="baseline")
    want = [gen.generate([p], max_new_tokens=6)[0][0] for p in prompts]
    with ModelRegistry(max_models=1, name="stable_reg",
                       decode_path="baseline", max_seq=64, num_slots=2,
                       page_size=16, prefill_chunk=16) as reg:
        for name in ("a", "b", "a"):
            engine = reg.load(name, factory=lambda: port)
            assert engine.decode_path == "baseline"
            got = [reg.submit(name, p, max_new_tokens=6).result(
                timeout=WAIT)["tokens"] for p in prompts]
            assert got == want, name


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_speculative_tokens_equal_generator(multistep):
    """A ``SpeculativeGenerator`` on a baseline target (its verify pass a
    T = k + 1 step) gives the baseline ``Generator``'s greedy tokens, with
    the target itself as the draft (every proposal accepted) and with a
    2-layer draft."""
    _, port, vocab = _models("llama_tiny_test")
    trandom.seed(1)
    draft = get_llama("llama_tiny_test", device="cpu", num_layers=2)
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,),
              decode_path="baseline")
    prompts = _prompts(vocab, 11, (5, 14))
    want, _ = Generator(port, **kw).generate(prompts, max_new_tokens=12)
    for d, accept in ((port, 1.0), (draft, None)):
        sg = SpeculativeGenerator(port, d, k=3, multistep=multistep, **kw)
        assert sg.decode_path == "baseline"
        sg.warmup()
        out, info = sg.generate(prompts, max_new_tokens=12)
        assert out == want
        if accept is not None:
            assert info["acceptance_rate"] == accept


def test_strict_parity_flag_pins_every_entry_point(monkeypatch):
    """``MXNET_SERVE_STRICT_PARITY=1`` overrides ``decode_path`` on the
    ``Generator``, the engine and the speculative target, and the strict
    ``Generator`` serves the baseline tokens."""
    _, port, vocab = _models("llama_tiny_test")
    kw = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))
    prompts = _prompts(vocab, 12, (6, 9))
    want, _ = Generator(port, decode_path="baseline", **kw).generate(
        prompts, max_new_tokens=6)
    monkeypatch.setenv("MXNET_SERVE_STRICT_PARITY", "1")
    gen = Generator(port, decode_path="pallas", **kw)
    assert gen.decode_path == "baseline"
    assert gen.generate(prompts, max_new_tokens=6)[0] == want
    assert SpeculativeGenerator(port, port, k=2, decode_path="int8",
                                **kw).decode_path == "baseline"
    with ContinuousEngine(port, max_seq=64, num_slots=2, page_size=16,
                          prefill_chunk=16, decode_path="pallas") as eng:
        assert eng.decode_path == "baseline"
        got = [f.result(timeout=WAIT)["tokens"]
               for f in [eng.submit(p, max_new_tokens=6) for p in prompts]]
    assert got == want
