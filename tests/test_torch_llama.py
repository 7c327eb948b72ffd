"""The port's Llama decoder and ``Generator`` against the JAX package's.

Weights come from the JAX model (``mx.random.seed(0)``, default init) and
are carried across with ``load_reference_params``; token inputs come from
numpy. Both ``Generator``s run the same rung on the CPU: the JAX package's
``pallas`` rung takes its ``_xla_decode`` fallback there, the port's its
plain ``decode_attention_torch``. No test here holds the port to the JAX
``Generator``'s ``baseline`` rung (its deterministic compiler options are
refused by the installed JAX); the port's own ``baseline`` rung is held to
the JAX eager cache path in ``test_torch_stable.py``.

Tolerances (max abs over all logits): 1e-4 on ``pallas``, where only the
order of f32 sums differs (measured ~1e-6 on these configs); 1e-2 on
``int8``, where a K/V element whose f32 value lands a rounding step apart
in the two packages quantizes one int8 step apart (measured ~1e-4).
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.serve import Generator as JaxGenerator
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.serve import (Generator, InferenceSession, ServeError,
                                   pick_bucket, sample_tokens)
from mxnet_tpu_torch.serve import generate as tgen

TOL = {"pallas": 1e-4, "int8": 1e-2}
CONFIGS = ["llama_tiny_test", "llama_serve_12l_test"]
GEN_KW = dict(max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))

_MODELS = {}
_GENS = {}


def _models(config):
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


def _generators(config, rung):
    if (config, rung) not in _GENS:
        net, port, _ = _models(config)
        _GENS[config, rung] = (JaxGenerator(net, decode_path=rung, **GEN_KW),
                               Generator(port, decode_path=rung, **GEN_KW))
    return _GENS[config, rung]


def test_load_reference_params_carries_every_weight():
    net, port, _ = _models("llama_tiny_test")
    ref = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    own = dict(port.named_parameters())
    assert sorted(own) == sorted(ref)
    for name, p in own.items():
        np.testing.assert_array_equal(p.detach().numpy(), ref[name])
    fresh = get_llama("llama_tiny_test", device="cpu")
    with pytest.raises(MXNetError, match="missing"):
        load_reference_params(fresh, {k: v for k, v in ref.items()
                                      if k != "norm.gamma"})
    with pytest.raises(MXNetError, match="unused"):
        load_reference_params(fresh, dict(ref, extra=np.zeros(1)))
    bad = dict(ref)
    bad["embed.weight"] = bad["embed.weight"][:, :8]
    with pytest.raises(MXNetError, match="shape"):
        load_reference_params(fresh, bad)


@pytest.mark.parametrize("rung", ["pallas", "int8"])
@pytest.mark.parametrize("config", CONFIGS)
def test_prefill_and_teacher_forced_decode_logits(config, rung):
    """Prefill logits, then 32 teacher-forced decode steps, both rings
    advancing in lockstep from the same token stream."""
    _, _, vocab = _models(config)
    jg, pg = _generators(config, rung)
    rng = np.random.RandomState(1)
    toks = rng.randint(1, vocab, size=(2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jl, jc = jg.prefill(toks, lens, jg._fresh_cache(2))
    pl, pc = pg.prefill(toks, lens, pg._fresh_cache(2))
    assert tuple(pl.shape) == (2, vocab)
    errs = [float(np.abs(jl.asnumpy() - pl.numpy()).max())]
    pos = lens.copy()
    forced = rng.randint(1, vocab, size=(32, 2)).astype(np.int32)
    for step in range(32):
        jl, jc = jg.decode_step(forced[step], pos, jc)
        pl, pc = pg.decode_step(forced[step], pos, pc)
        errs.append(float(np.abs(jl.asnumpy() - pl.numpy()).max()))
        pos = pos + 1
    assert max(errs) <= TOL[rung], errs


@pytest.mark.parametrize("rung", ["pallas", "int8"])
@pytest.mark.parametrize("config", CONFIGS)
def test_greedy_generate_tokens_identical(config, rung):
    _, _, vocab = _models(config)
    jg, pg = _generators(config, rung)
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(1, vocab, size=n)]
               for n in (7, 12)]
    jout, _ = jg.generate(prompts, max_new_tokens=16)
    pout, info = pg.generate(prompts, max_new_tokens=16)
    assert [[int(t) for t in o] for o in jout] == pout
    assert [len(o) for o in pout] == [16, 16]
    assert info["decode_steps"] == 15


def test_int8_weights_when_forced_on(monkeypatch):
    """MXNET_SERVE_DECODE_INT8_WEIGHTS=1: both packages quantize the same
    projections to the same int8 values and dequantize them per step."""
    monkeypatch.setenv("MXNET_SERVE_DECODE_INT8_WEIGHTS", "1")
    net, port, vocab = _models("llama_tiny_test")
    jg = JaxGenerator(net, decode_path="int8", **GEN_KW)
    pg = Generator(port, decode_path="int8", **GEN_KW)
    assert len(pg._qweights) == 2 * 7 + 1 == len(jg._qindex)
    qw, scale = pg._qweights[id(port.lm_head.weight)]
    w = port.lm_head.weight.detach().numpy()
    ref_scale = np.maximum(np.abs(w).max(axis=1) / 127.0,
                           1e-8).astype(np.float32)
    np.testing.assert_array_equal(scale.numpy(), ref_scale)
    np.testing.assert_array_equal(
        qw.numpy(), np.clip(np.round(w / ref_scale[:, None]), -127,
                            127).astype(np.int8))
    rng = np.random.RandomState(3)
    toks = rng.randint(1, vocab, size=(2, 16)).astype(np.int32)
    lens = np.array([5, 16], np.int32)
    jl, jc = jg.prefill(toks, lens, jg._fresh_cache(2))
    pl, pc = pg.prefill(toks, lens, pg._fresh_cache(2))
    errs = [float(np.abs(jl.asnumpy() - pl.numpy()).max())]
    for step in range(8):
        ids = rng.randint(1, vocab, size=2).astype(np.int32)
        jl, jc = jg.decode_step(ids, lens + step, jc)
        pl, pc = pg.decode_step(ids, lens + step, pc)
        errs.append(float(np.abs(jl.asnumpy() - pl.numpy()).max()))
    assert max(errs) <= TOL["int8"], errs


def test_warmup_then_no_new_signatures():
    _, port, _ = _models("llama_tiny_test")
    gen = Generator(port, max_seq=64, batch_buckets=(1, 2),
                    prompt_buckets=(8, 16))
    w = gen.warmup()
    # 2 batch buckets x (2 prefill buckets + 1 decode)
    assert w["signatures"] == 6
    gen.generate([[1, 2, 3]], max_new_tokens=5)
    gen.generate([[4] * 11, [5] * 2], max_new_tokens=5)
    gen.assert_no_recompiles()
    assert gen.session.signature_count() == 6
    gen.session.run(torch.zeros(3, 1, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32),
                    *tgen.KVCache.alloc(port, 3, 64).flat())
    with pytest.raises(ServeError, match="new shape signatures"):
        gen.assert_no_recompiles()


def test_deadlines_retire_a_row():
    _, port, _ = _models("llama_tiny_test")
    gen = Generator(port, **GEN_KW)
    now = time.monotonic()
    out, info = gen.generate([[1, 2, 3], [4, 5]], max_new_tokens=8,
                             deadlines=[now, now + 60])
    assert info["deadline_expired"] == [0]
    assert len(out[0]) == 1 and len(out[1]) == 8
    with pytest.raises(MXNetError, match="deadlines"):
        gen.generate([[1, 2, 3], [4, 5]], max_new_tokens=2,
                     deadlines=[now])


def test_bucket_overflow_is_rejected():
    assert pick_bucket(3, (1, 2, 4)) == 4
    with pytest.raises(ServeError, match="exceeds the largest"):
        pick_bucket(5, (1, 2, 4))
    _, port, _ = _models("llama_tiny_test")
    gen = Generator(port, **GEN_KW)
    with pytest.raises(ServeError):
        gen.generate([[1]] * 3, max_new_tokens=2)
    with pytest.raises(ServeError):
        gen.generate([[1] * 17], max_new_tokens=2)
    with pytest.raises(MXNetError, match="max_seq"):
        gen.generate([[1] * 16], max_new_tokens=49)


def test_unported_options_raise(monkeypatch):
    """Every serving option constructs and serves (the name stays from
    when some raised): paged KV, the prefix cache, multi-step decode, the
    strict ``baseline`` rung, and ``MXNET_SERVE_STRICT_PARITY``, which pins
    a default Generator to ``baseline``."""
    _, port, _ = _models("llama_tiny_test")
    for kw in ({"paged": True}, {"prefix_cache": True}, {"multistep": True},
               {"decode_path": "baseline"}):
        out, _ = Generator(port, **GEN_KW, **kw).generate([[1, 2, 3]],
                                                          max_new_tokens=3)
        assert len(out[0]) == 3, kw
    base, _ = Generator(port, decode_path="baseline", **GEN_KW).generate(
        [[1, 2, 3]], max_new_tokens=3)
    monkeypatch.setenv("MXNET_SERVE_STRICT_PARITY", "1")
    strict = Generator(port, **GEN_KW)
    assert strict.decode_path == "baseline"
    assert strict.generate([[1, 2, 3]], max_new_tokens=3)[0] == base
    monkeypatch.delenv("MXNET_SERVE_STRICT_PARITY")
    monkeypatch.setenv("MXNET_SERVE_DECODE_PATH", "int8")
    assert Generator(port, **GEN_KW).decode_path == "int8"
    # the cache-free forward runs (flash attention, ported): full logits
    with torch.no_grad():
        logits = port(torch.zeros(1, 4, dtype=torch.long))
    assert tuple(logits.shape) == (1, 4, port.embed.weight.shape[0])
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(MXNetError, match="decode_path"):
        Generator(port, decode_path="spec")


def test_kv_cache_layout_and_bytes():
    _, port, _ = _models("llama_tiny_test")
    f32 = tgen.KVCache.alloc(port, 2, 64)
    q8 = tgen.KVCache.alloc(port, 2, 64, quant="int8")
    # tiny: 2 layers x (2, kv 2, 64, head_dim 16)
    assert f32.nbytes() == 2 * 2 * (2 * 2 * 64 * 16) * 4
    assert q8.nbytes() == 2 * 2 * (2 * 2 * 64 * 16 + 2 * 2 * 64 * 4)
    assert len(q8.flat()) == 8 and q8.flat()[1].dtype == torch.float32
    back = tgen.KVCache.from_flat(q8.flat(), 64, quant="int8")
    assert all(a is b for a, b in zip(back.flat(), q8.flat()))
    with pytest.raises(MXNetError):
        tgen.KVCache.from_flat(f32.flat()[:3], 64)


def test_sample_tokens():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, -1.0, 0.0, 4.9]])
    assert sample_tokens(logits).tolist() == [1, 0]  # ties: lowest id
    trandom.seed(7)
    a = sample_tokens(logits, temperature=1.0, top_k=2)
    trandom.seed(7)
    b = sample_tokens(logits, temperature=1.0, top_k=2)
    assert a.tolist() == b.tolist() and a.dtype == np.int32
    trandom.seed(8)
    draws = {tuple(sample_tokens(logits, temperature=5.0, top_k=2))
             for _ in range(50)}
    assert all(r0 in (1, 3) and r1 in (0, 3) for r0, r1 in draws)


def test_inference_session_predict_pads_and_unpads():
    class Sum(torch.nn.Module):
        def forward(self, x):
            return x * 2

    sess = InferenceSession(Sum(), batch_buckets=(2, 4), seq_buckets=(4, 8),
                            device="cpu")
    assert sess.warmup(np.ones((1, 3), np.int32)) == 4
    out = sess.predict(np.arange(6, dtype=np.int32).reshape(3, 2))
    assert out.tolist() == [[0, 2], [4, 6], [8, 10]]
    sess.assert_no_recompiles()
    sess.run(torch.zeros(5, 4))
    with pytest.raises(ServeError):
        sess.assert_no_recompiles()
