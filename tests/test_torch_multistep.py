"""The port's multi-step decode (``Generator(multistep=True)``) and its
on-device sampling (``ops.nn.sample_step``) against the JAX package's.

On the CPU the super-step runs its body as a plain loop of N iterations
(the GPU replays the same body as a CUDA graph; ``test_torch_cuda.py``
holds the two together on the card). Greedy tokens are held to the JAX
package's multi-step ``Generator`` on the ``pallas`` and ``int8`` rungs
(not its ``baseline`` rung, whose compiler options the installed JAX
refuses; the port's baseline super-step is held to its single step in
``test_torch_stable.py``) at N = 8 and N = 1, and to the port's own
single-step ``Generator``. Sampled draws cannot match JAX's threefry
bits, so the sampled branch is held to its own properties: a counter-based
stream (N = 8 and N = 1 give the same tokens), the top-k rule, and the
frequencies of ``softmax(logits / T)``. Weights come from the JAX model
through ``load_reference_params``; inputs from numpy with a seed.
"""
import math
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy as mnp
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.serve import Generator as JaxGenerator
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.serve import Generator

CONFIGS = ["llama_tiny_test", "llama_serve_12l_test"]
GEN_KW = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))

_MODELS = {}


def _models(config="llama_tiny_test"):
    """(JAX model, port model with the JAX model's weights, vocab)."""
    if config not in _MODELS:
        mx.random.seed(0)
        net = jax_get_llama(config)
        net.initialize()
        params = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        port = load_reference_params(get_llama(config, device="cpu"), params)
        _MODELS[config] = (net, port, params["embed.weight"].shape[0])
    return _MODELS[config]


def _prompts(vocab, seed, lens=(7, 12)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=n)] for n in lens]


# ---------------------------------------------------------------------------
# sample_step
# ---------------------------------------------------------------------------


def _jax_sample(logits, temps, tks, seeds, pos, key):
    return jops.sample_step(mnp.array(logits), mnp.array(temps),
                            mnp.array(tks), mnp.array(seeds),
                            mnp.array(pos), mnp.array(key)).asnumpy()


def _port_sample(logits, temps, tks, seeds, pos, key):
    return tops.sample_step(*(torch.from_numpy(np.asarray(a)) for a in (
        logits, temps, tks, seeds, pos, key.astype(np.int64)))).numpy()


def test_sample_step_greedy_branch_equals_jax():
    """Rows at temperature <= 0 take argmax, ties to the lowest id, the JAX
    op's ids exactly; rows at temperature > 0 in the same batch do not
    disturb them."""
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 300).astype(np.float32)
    logits[1, [7, 9, 250]] = 50.0                   # a three-way tie
    logits[2] = 0.0                                 # all tied
    temps = np.array([0.0, 0.0, -1.0, 0.0, 0.7, 0.0], np.float32)
    tks = np.array([0, 5, 0, 300, 3, 1], np.int32)
    seeds = np.arange(6, dtype=np.int32)
    pos = rng.randint(0, 1000, size=6).astype(np.int32)
    key = np.array([123, 456], np.uint32)
    want = _jax_sample(logits, temps, tks, seeds, pos, key)
    got = _port_sample(logits, temps, tks, seeds, pos, key)
    greedy = temps <= 0
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], np.argmax(logits, -1)[greedy])
    assert got[1] == 7 and got[2] == 0
    allg = np.zeros(6, np.float32)
    np.testing.assert_array_equal(
        _port_sample(logits, allg, tks, seeds, pos, key),
        _jax_sample(logits, allg, tks, seeds, pos, key))


def test_sample_step_is_a_counter_based_stream():
    """A draw is a pure function of (key, seed, position, vocab index):
    the same inputs give the same ids, in any batch arrangement; the key,
    the seed and the position each move it."""
    rng = np.random.RandomState(1)
    v, n = 64, 256
    logits = np.repeat(rng.randn(1, v).astype(np.float32), n, 0)
    temps = np.ones(n, np.float32)
    tks = np.zeros(n, np.int32)
    seeds = np.zeros(n, np.int32)
    pos = np.arange(n, dtype=np.int32)
    key = np.array([7, 2 ** 32 - 1], np.uint32)
    a = _port_sample(logits, temps, tks, seeds, pos, key)
    b = _port_sample(logits, temps, tks, seeds, pos, key)
    np.testing.assert_array_equal(a, b)
    perm = rng.permutation(n)
    np.testing.assert_array_equal(
        _port_sample(logits[perm], temps, tks, seeds, pos[perm], key),
        a[perm])
    for other in (
            _port_sample(logits, temps, tks, seeds, pos,
                         np.array([8, 2 ** 32 - 1], np.uint32)),
            _port_sample(logits, temps, tks, seeds + 1, pos, key),
            _port_sample(logits, temps, tks, seeds, pos + 1, key)):
        assert (other != a).mean() > 0.5
    u = tops.counter_uniform(torch.tensor([7, 2 ** 32 - 1]),
                             torch.zeros(4, dtype=torch.int32),
                             torch.arange(4, dtype=torch.int32), 1000)
    assert u.dtype == torch.float64 and bool(((u > 0) & (u < 1)).all())


def test_sample_step_top_k_keeps_only_the_k_largest():
    """top_k = k keeps the values >= the k-th largest (ties included);
    0 and >= V keep everything."""
    v, n = 10, 2000
    row = np.array([3.0, 1.0, 2.0, 2.0, 0.5, -1.0, 0.0, 1.5, -2.0, 0.2],
                   np.float32)
    logits = np.repeat(row[None], n, 0)
    temps = np.full(n, 2.0, np.float32)
    seeds = np.zeros(n, np.int32)
    pos = np.arange(n, dtype=np.int32)
    key = np.array([5, 6], np.uint32)
    for k, allowed in ((1, {0}), (2, {0, 2, 3}), (3, {0, 2, 3}),
                       (4, {0, 2, 3, 7})):
        got = _port_sample(logits, temps, np.full(n, k, np.int32), seeds,
                           pos, key)
        assert set(got.tolist()) == allowed, k
    for k in (0, v, v + 5):
        got = _port_sample(logits, temps, np.full(n, k, np.int32), seeds,
                           pos, key)
        assert set(got.tolist()) == set(range(v)), k


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_sample_step_frequencies_follow_softmax(temp):
    """4000 positions of one (V = 8) logits row: each id's count lies
    within 4 sigma of 4000 * softmax(logits / T). Deterministic: the
    draws are counters, not a stateful stream."""
    n = 4000
    row = np.array([1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.25, 1.5], np.float32)
    got = _port_sample(np.repeat(row[None], n, 0), np.full(n, temp,
                                                            np.float32),
                       np.zeros(n, np.int32), np.full(n, 3, np.int32),
                       np.arange(n, dtype=np.int32),
                       np.array([11, 22], np.uint32))
    p = np.exp(row / temp - (row / temp).max())
    p /= p.sum()
    counts = np.bincount(got, minlength=8)
    sigma = np.sqrt(n * p * (1 - p))
    assert (np.abs(counts - n * p) <= 4 * sigma).all(), (counts, n * p)


# ---------------------------------------------------------------------------
# the multi-step Generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [8, 1])
@pytest.mark.parametrize("rung", ["pallas", "int8"])
@pytest.mark.parametrize("config", CONFIGS)
def test_greedy_tokens_identical_to_jax_and_single_step(config, rung, steps):
    net, port, vocab = _models(config)
    prompts = _prompts(vocab, 2)
    jg = JaxGenerator(net, decode_path=rung, multistep=True,
                      decode_steps=steps, name=f"tms_{config}_{rung}_{steps}",
                      **GEN_KW)
    single = Generator(port, decode_path=rung, **GEN_KW)
    gen = Generator(port, decode_path=rung, multistep=True,
                    decode_steps=steps, **GEN_KW)
    w = gen.warmup()
    # 1 prefill + 1 decode step + the super-step graphs of (N, 1) x
    # (greedy, sampled)
    assert w["signatures"] == 2 + (4 if steps > 1 else 2)
    jout, jinfo = jg.generate(prompts, max_new_tokens=16)
    want, _ = single.generate(prompts, max_new_tokens=16)
    got, info = gen.generate(prompts, max_new_tokens=16)
    assert got == want == [[int(t) for t in o] for o in jout]
    assert [len(o) for o in got] == [16, 16]
    assert info["decode_visits"] == math.ceil(15 / steps)
    assert info["decode_visits"] == jinfo["decode_visits"]
    assert info["decode_steps"] == 15
    gen.assert_no_recompiles()


@pytest.mark.parametrize("max_new", [1, 2, 9, 17, 32])
def test_decode_visits_amortize(max_new):
    """decode_visits == ceil((max_new - 1) / N): the prefill's token comes
    first, every later one from a super-step."""
    _, port, vocab = _models()
    gen = Generator(port, multistep=True, decode_steps=8, max_seq=64,
                    batch_buckets=(1, 2), prompt_buckets=(16,))
    single = Generator(port, max_seq=64, batch_buckets=(1, 2),
                       prompt_buckets=(16,))
    gen.warmup()
    prompts = _prompts(vocab, 3, lens=(5,))
    got, info = gen.generate(prompts, max_new_tokens=max_new)
    assert info["decode_visits"] == math.ceil((max_new - 1) / 8)
    assert got == single.generate(prompts, max_new_tokens=max_new)[0]
    gen.assert_no_recompiles()


def test_stop_id_mid_super_step_truncates():
    """A stop id taken from the greedy stream lands inside a super-step:
    the lane freezes on the device, the host settle truncates at it, and
    the output equals the single-step loop's with the same stop set."""
    _, port, vocab = _models("llama_serve_12l_test")
    single = Generator(port, **GEN_KW)
    gen = Generator(port, multistep=True, decode_steps=8, **GEN_KW)
    gen.warmup()
    prompts = _prompts(vocab, 6)
    ref, _ = single.generate(prompts, max_new_tokens=16)
    stop = ref[0][5]  # row 0's 6th token: mid-block at N = 8
    want, _ = single.generate(prompts, max_new_tokens=16, stop_ids=[stop])
    got, _ = gen.generate(prompts, max_new_tokens=16, stop_ids=[stop])
    assert got == want
    assert len(got[0]) == ref[0].index(stop) < 16
    gen.assert_no_recompiles()


def test_sampled_stream_invariant_to_super_step_boundary():
    """Under a fixed seed, N = 8 and N = 1 give the same sampled tokens
    (the draws are keyed by position, not drawn in order); another seed
    gives another stream; greedy runs draw no host key."""
    _, port, vocab = _models()
    g8 = Generator(port, multistep=True, decode_steps=8, **GEN_KW)
    g1 = Generator(port, multistep=True, decode_steps=1, **GEN_KW)
    prompts = _prompts(vocab, 7)
    trandom.seed(7)
    a, _ = g8.generate(prompts, max_new_tokens=14, temperature=0.9, top_k=5)
    trandom.seed(7)
    b, _ = g1.generate(prompts, max_new_tokens=14, temperature=0.9, top_k=5)
    trandom.seed(8)
    c, _ = g8.generate(prompts, max_new_tokens=14, temperature=0.9, top_k=5)
    assert a == b and a != c
    trandom.seed(9)
    state = trandom.generator("cpu").get_state()
    g8.generate(prompts, max_new_tokens=6)
    assert torch.equal(trandom.generator("cpu").get_state(), state)


def test_steps_limit_degrades_to_one_under_a_deadline():
    _, port, vocab = _models()
    gen = Generator(port, multistep=True, decode_steps=8, **GEN_KW)
    now = time.monotonic()
    assert gen._steps_limit([now + 0.1], [False], 1) == 8  # no estimate yet
    gen._itl_est = 0.050
    assert gen._steps_limit([now + 0.1], [False], 1) == 1
    assert gen._steps_limit([now + 60.0], [False], 1) == 8
    assert gen._steps_limit([now + 0.1, now + 60.0], [True, False], 2) == 8
    gen.warmup()
    n_sig = gen._msession.signature_count()
    prompts = _prompts(vocab, 8)
    want, _ = gen.generate(prompts, max_new_tokens=6)
    # every deadline looks tight (the estimate halves toward the measured
    # time each visit, and stays above 30 s / 8): one step a visit
    gen._itl_est = 1000.0
    out, info = gen.generate(prompts, max_new_tokens=6,
                             deadlines=[time.monotonic() + 30.0] * 2)
    assert out == want and info["decode_visits"] == 5
    assert gen._msession.signature_count() == n_sig
    gen.assert_no_recompiles()
    # a passed deadline retires its row with what it has
    out, info = gen.generate(prompts, max_new_tokens=8,
                             deadlines=[time.monotonic() - 1.0,
                                        time.monotonic() + 60.0])
    assert info["deadline_expired"] == [0]
    assert len(out[0]) == 1 and out[1] == want[1] + out[1][6:]
    assert len(out[1]) == 8


def test_no_new_signature_after_warmup_and_bad_steps():
    _, port, _ = _models()
    gen = Generator(port, multistep=True, decode_steps=4, max_seq=64,
                    batch_buckets=(1, 2), prompt_buckets=(8, 16))
    w = gen.warmup()
    # per bucket: 2 prefills + 1 decode step, and 4 super-step graphs
    assert w["signatures"] == 2 * (3 + 4)
    for i in range(3):
        gen.generate([[1 + i, 2, 3]], max_new_tokens=6)
        gen.generate([[4] * 11, [5] * 2], max_new_tokens=9,
                     temperature=0.5)
    gen.assert_no_recompiles()
    assert gen.stats()["multistep"]["signatures"] == 8
    toks, lens, bb = gen._pad_prompts([[1, 2]])
    cache = gen._fresh_cache(bb)
    with pytest.raises(MXNetError, match="steps_limit"):
        gen.decode_super(np.zeros(1), lens, 3, np.zeros(1), np.zeros(1),
                         np.zeros(1), np.zeros(1), np.full((1, 8), -1),
                         np.zeros(2), cache)
    with pytest.raises(MXNetError, match="multistep"):
        Generator(port, **GEN_KW).decode_super(
            np.zeros(1), lens, 1, np.zeros(1), np.zeros(1), np.zeros(1),
            np.zeros(1), np.full((1, 8), -1), np.zeros(2), cache)


def test_multistep_flags(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_MULTISTEP", "1")
    monkeypatch.setenv("MXNET_SERVE_DECODE_STEPS", "3")
    _, port, _ = _models()
    gen = Generator(port, **GEN_KW)
    assert gen._multistep and gen.decode_steps == 3
    out, info = gen.generate([[5, 6, 7]], max_new_tokens=7)
    assert len(out[0]) == 7 and info["decode_visits"] == 2
