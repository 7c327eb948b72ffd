"""The port's speculative decoding (``serve.SpeculativeGenerator``) against
the JAX package's, and against the port's own greedy ``Generator``.

Greedy tokens and the round statistics are held to the JAX
``SpeculativeGenerator`` on the ``pallas`` and ``int8`` rungs (not its
``baseline`` rung, whose compiler options the installed JAX refuses; the
port's baseline target is held to its own ``Generator`` in
``test_torch_stable.py``), with and without ``multistep``, on rings and on paged
pools with the prefix cache on (the second pass of the same prompts hits
the trie of both the draft and the target). The verify pass's
all-position logits (``_CacheForward(all_logits=True)``) are held to the
JAX verify session's. On the CPU the verify pass and the draft's
super-step run their bodies eagerly (the GPU replays the same bodies as
CUDA graphs; ``test_torch_cuda.py`` holds the two together on the card).
The graph sessions (the draft's super-step, the verify pass) run under
the same protection stack as the JAX package's sessions: the same
``serve:execute`` fault visits, breaker trips and watchdog timeouts are
held to the JAX generators' outcomes, and draining the owning session
waits for a replay in flight. Weights come from the JAX models through
``load_reference_params``; prompts from numpy with a seed.
"""
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serve import Generator as JaxGenerator
from mxnet_tpu.serve import ServiceUnavailable as JaxUnavailable
from mxnet_tpu.serve import SpeculativeGenerator as JaxSpeculative
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.ops.hopper import decode_attention as da
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serve import Generator, ServeError, \
    ServiceUnavailable, SpeculativeGenerator
from mxnet_tpu_torch.serve.generate import _STOP_WIDTH

K = 3
KW = dict(k=K, max_seq=64, batch_buckets=(2,), prompt_buckets=(16,))
PAGED = dict(paged=True, prefix_cache=True, page_size=8)
STAT_KEYS = ("rounds", "draft_steps", "verify_steps", "acceptance_rate",
             "deadline_expired")
NEW = 12

_MODELS = {}


def _params(net):
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


def _models(config):
    """(JAX target, JAX 2-layer random draft, port target, port draft,
    vocab), the port's weights copied from the JAX models."""
    if config not in _MODELS:
        mx.random.seed(0)
        net = jax_get_llama(config)
        net.initialize()
        mx.random.seed(1)
        dnet = jax_get_llama(config, num_layers=2)
        dnet.initialize()
        port = load_reference_params(get_llama(config, device="cpu"),
                                     _params(net))
        dport = load_reference_params(
            get_llama(config, device="cpu", num_layers=2), _params(dnet))
        vocab = _params(net)["embed.weight"].shape[0]
        _MODELS[config] = (net, dnet, port, dport, vocab)
    return _MODELS[config]


def _prompts(vocab, seed=0, lens=(7, 12)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=n)] for n in lens]


# (config, rung, multistep, layout): on the tiny config every (rung,
# mode) pair, both layouts among them; on the 12-layer config one paged
# multi-step and one ring single-step case
CASES = [
    ("llama_tiny_test", "pallas", False, "ring"),
    ("llama_tiny_test", "pallas", True, "paged"),
    ("llama_tiny_test", "int8", False, "paged"),
    ("llama_tiny_test", "int8", True, "ring"),
    ("llama_serve_12l_test", "pallas", True, "paged"),
    ("llama_serve_12l_test", "int8", False, "ring"),
]


@pytest.mark.parametrize("config,rung,multistep,layout", CASES)
def test_tokens_and_stats_equal_jax(config, rung, multistep, layout):
    """Greedy tokens and the round statistics equal the JAX
    ``SpeculativeGenerator``'s with a random draft, twice (paged: the
    second pass starts from prefix hits in both tries), and the tokens
    equal the port's own single-step greedy ``Generator``'s."""
    net, dnet, port, dport, vocab = _models(config)
    prompts = _prompts(vocab)
    kw = dict(KW, decode_path=rung, multistep=multistep,
              **(PAGED if layout == "paged" else {}))
    jsg = JaxSpeculative(net, dnet, **kw)
    jsg.warmup()
    tsg = SpeculativeGenerator(port, dport, **kw)
    tsg.warmup()
    for _ in range(2):
        jout, jinfo = jsg.generate(prompts, max_new_tokens=NEW)
        tout, tinfo = tsg.generate(prompts, max_new_tokens=NEW)
        assert tout == jout
        assert {k: tinfo[k] for k in STAT_KEYS} == \
            {k: jinfo[k] for k in STAT_KEYS}
        assert tinfo["draft_steps"] == tinfo["rounds"] * (K + 1)
        assert tinfo["decode_visits"] == tinfo["rounds"] * (
            2 if multistep else K + 2)
    if layout == "paged":
        for gen in (tsg.target, tsg.draft):
            assert gen.stats()["prefix"][2]["tokens_matched"] > 0
    tsg.assert_no_recompiles()
    ref = Generator(port, max_seq=64, batch_buckets=(2,),
                    prompt_buckets=(16,), decode_path=rung)
    assert tout == ref.generate(prompts, max_new_tokens=NEW)[0]


@pytest.mark.parametrize("rung", ["pallas", "int8"])
@pytest.mark.parametrize("multistep", [False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_tokens_equal_target_generator(rung, multistep, layout):
    """For a copied draft (the target itself: every proposal accepted) and
    a random one (almost none accepted) the port's speculative tokens
    equal its target ``Generator``'s greedy tokens, with stop ids and a
    budget that ends mid-round."""
    _, _, port, dport, vocab = _models("llama_tiny_test")
    prompts = _prompts(vocab, seed=3, lens=(5, 14))
    ref = Generator(port, max_seq=64, batch_buckets=(2,),
                    prompt_buckets=(16,), decode_path=rung)
    want, _ = ref.generate(prompts, max_new_tokens=NEW)
    stop = (want[0][5],)
    want_stop, _ = ref.generate(prompts, max_new_tokens=NEW, stop_ids=stop)
    kw = dict(KW, decode_path=rung, multistep=multistep,
              **(PAGED if layout == "paged" else {}))
    for draft, accept in ((port, 1.0), (dport, None)):
        sg = SpeculativeGenerator(port, draft, **kw)
        sg.warmup()
        out, info = sg.generate(prompts, max_new_tokens=NEW)
        assert out == want
        if accept is not None:
            assert info["acceptance_rate"] == accept
        assert sg.generate(prompts, max_new_tokens=NEW,
                           stop_ids=stop)[0] == want_stop
        assert sg.generate(prompts, max_new_tokens=NEW - 2)[0] == [
            w[:NEW - 2] for w in want]
        sg.assert_no_recompiles()


@pytest.mark.parametrize("rung,tol,paged", [("pallas", 1e-5, False),
                                            ("int8", 1e-4, True)])
def test_verify_logits_equal_jax(rung, tol, paged):
    """The verify pass (``_CacheForward(all_logits=True)`` over the
    target's cache after a prefill) gives every position's logits within
    1e-5 (``pallas``) and 1e-4 (``int8``) max abs of the JAX verify
    session's, and argmax ids equal to theirs."""
    net, dnet, port, dport, vocab = _models("llama_serve_12l_test")
    prompts = _prompts(vocab, seed=5)
    kw = dict(KW, decode_path=rung, **(dict(paged=True, page_size=8)
                                       if paged else {}))
    jsg = JaxSpeculative(net, dnet, **kw)
    tsg = SpeculativeGenerator(port, dport, **kw)
    rng = np.random.RandomState(7)
    blk = rng.randint(1, vocab, size=(2, K + 1)).astype(np.int32)
    got = []
    for sg in (jsg, tsg):
        toks, lens, bb = sg.target._pad_prompts(prompts)
        cache = sg.target._fresh_cache(bb)
        _, cache = sg.target.prefill(toks, lens, cache)
        out = sg._verify_run(blk, lens, cache)
        got.append(np.asarray(out[0].asnumpy() if sg is jsg
                              else out[0].numpy()))
    jl, tl = got
    assert tl.shape == (2, K + 1, vocab)
    assert np.abs(tl - jl).max() <= tol
    assert (tl.argmax(-1) == jl.argmax(-1)).all()


def test_all_logits_forward_shapes():
    """``all_logits`` returns (B, T, vocab) and ignores ``last_idx``; its
    last position equals the last-position step's logits."""
    from mxnet_tpu_torch.serve.generate import KVCache, _CacheForward

    _, _, port, _, vocab = _models("llama_tiny_test")
    toks = torch.from_numpy(np.asarray(_prompts(vocab, lens=(6, 6)),
                                       np.int32))
    sp = torch.zeros(2, dtype=torch.int32)
    li = torch.full((2,), 5, dtype=torch.int32)
    outs = []
    for all_logits in (True, False):
        cache = KVCache.alloc(port, 2, 32)
        step = _CacheForward(port, 32, all_logits=all_logits)
        with torch.inference_mode():
            outs.append(step(toks, sp, li, *cache.flat())[0])
    assert tuple(outs[0].shape) == (2, 6, vocab)
    torch.testing.assert_close(outs[0][:, 5], outs[1], rtol=0, atol=1e-6)


def test_greedy_only_headroom_and_recompiles():
    """``temperature > 0`` raises; a prompt + budget that leaves less than
    k+1 positions of headroom raises; prefix mode reserves the k+1
    overhang in both pools; ``assert_no_recompiles`` spans the target,
    the draft (its super-step graphs included) and the verify session."""
    _, _, port, dport, vocab = _models("llama_tiny_test")
    sg = SpeculativeGenerator(port, dport, multistep=True, **PAGED, **KW)
    prompts = _prompts(vocab)
    with pytest.raises(MXNetError, match="greedy-only"):
        sg.generate(prompts, max_new_tokens=4, temperature=0.7)
    with pytest.raises(MXNetError, match="speculative headroom"):
        sg.generate(prompts, max_new_tokens=64 - 12 - K)
    assert sg.target._budget_headroom == sg.draft._budget_headroom == K + 1
    assert sg.draft.decode_steps == K + 1
    assert sg.target._msession is None and sg.draft._msession is not None
    w = sg.warmup()
    assert w["signatures"] > 0
    out, _ = sg.generate(prompts, max_new_tokens=64 - 12 - K - 1)
    assert [len(o) for o in out] == [64 - 12 - K - 1] * 2
    for gen in (sg.target, sg.draft):
        pool = gen._fresh_cache(2)
        assert pool.stats()["pages_owned"] == 0
    sg.assert_no_recompiles()
    # a verify pass on another attention route is a new signature of the
    # verify session (its graph key carries the route)
    da.force_path("torch")
    try:
        sg.generate(prompts, max_new_tokens=4)
    finally:
        da.force_path(None)
    with pytest.raises(ServeError, match="new signatures"):
        sg.assert_no_recompiles()
    with pytest.raises(ServeError, match="llama_spec_verify"):
        sg._verify.assert_no_recompiles()


def test_deadline_retires_rows_between_rounds():
    """A row whose deadline has passed retires at the next round boundary
    with the tokens settled so far, as the JAX generator does."""
    _, _, port, dport, vocab = _models("llama_tiny_test")
    sg = SpeculativeGenerator(port, dport, **KW)
    sg.warmup()
    now = time.monotonic()
    out, info = sg.generate(_prompts(vocab), max_new_tokens=NEW,
                            deadlines=[now - 1.0, now + 60.0])
    assert info["deadline_expired"] == [0]
    assert len(out[1]) == NEW and 1 <= len(out[0]) < NEW


# -- the protection stack on the graph sessions ------------------------------

@pytest.fixture
def _no_plan():
    yield
    for f in (jfaults, tfaults):
        f.clear_plan()


def _gen_outcome(fn):
    try:
        return ("ok", fn()[0])
    except (ServiceUnavailable, JaxUnavailable) as e:
        return ("503", "breaker" in str(e), "draining" in str(e),
                "MXNET_SERVE_TIMEOUT_MS" in str(e))
    except Exception as e:  # noqa: BLE001 -- the outcome is the class name
        return ("err", type(e).__name__)


def _sessions(gen):
    """Every session of a generator, in a fixed order: the target's (or
    the plain generator's) prefill session and super-step session, the
    draft's two, the verify session."""
    if hasattr(gen, "_verify"):
        return (_sessions(gen.target) + _sessions(gen.draft)
                + [gen._verify])
    return [gen.session] + ([gen._msession] if gen._msession is not None
                            else [])


def _build(kind, side):
    net, dnet, port, dport, _ = _models("llama_tiny_test")
    target, draft = (net, dnet) if side == "jax" else (port, dport)
    if kind == "generator":
        cls = JaxGenerator if side == "jax" else Generator
        return cls(target, max_seq=64, batch_buckets=(2,),
                   prompt_buckets=(16,), decode_path="pallas",
                   multistep=True, decode_steps=4)
    cls = JaxSpeculative if side == "jax" else SpeculativeGenerator
    return cls(target, draft, decode_path="pallas",
               multistep=(kind == "spec_multi"), **KW)


# serve:execute visits a generate makes before the one that fails: the
# multi-step generator's are prefill, super-step; the speculative ones'
# target and draft prefill, then the draft's super-step (or its k+1
# single steps), then the verify pass
# (the tripped session's place in ``_sessions``)
BREAKER_CASES = [("generator", [1, 3, 5], 1),
                 ("spec_multi", [3, 7, 11], 3),
                 ("spec_single", [6, 13, 20], 2)]


@pytest.mark.parametrize("kind,at,tripped", BREAKER_CASES)
def test_graph_session_breaker_matches_jax(kind, at, tripped, _no_plan):
    """A fatal ``serve:execute`` fault on three generates' super-step (or
    verify) visits trips that graph session's breaker, as it trips the
    JAX generator's session of the same pass: the next generates are 503
    ``breaker`` rejects (never another route), then a half-open probe
    heals it and the tokens are the unfaulted ones. The outcomes and
    every session's breaker readout equal the JAX generator's."""
    _, _, _, _, vocab = _models("llama_tiny_test")
    prompts = _prompts(vocab, seed=11)
    plan = {"rules": [{"site": "serve:execute", "kind": "fatal",
                       "at": at}]}
    res = []
    for side, f in (("jax", jfaults), ("port", tfaults)):
        gen = _build(kind, side)
        gen.warmup()
        want = gen.generate(prompts, max_new_tokens=NEW)[0]
        f.install_plan(plan)
        try:
            rows = []
            for _ in range(13):
                rows.append((_gen_outcome(lambda: gen.generate(
                    prompts, max_new_tokens=NEW)),
                    [s.breaker.snapshot() for s in _sessions(gen)]))
        finally:
            f.clear_plan()
        res.append((want, rows))
    assert res[0] == res[1]
    want, rows = res[1]
    outcomes = [r[0] for r in rows]
    assert outcomes[:3] == [("err", "InjectedFaultError")] * 3
    assert outcomes[3:11] == [("503", True, False, False)] * 8
    assert outcomes[11:] == [("ok", want)] * 2
    states = [b["state"] for b in rows[2][1]]
    assert states == ["closed"] * tripped + ["open"] + ["closed"] * (
        len(states) - tripped - 1)


@pytest.mark.parametrize("kind", ["generator", "spec_multi"])
def test_graph_session_watchdog_timeout_matches_jax(kind, _no_plan,
                                                   monkeypatch):
    """With ``MXNET_SERVE_TIMEOUT_MS`` set after warmup, a hung super-step
    (a 1 s delay at its ``serve:execute`` visit) is a 503 naming the
    timeout and one breaker failure of that session, as in the JAX
    generator; the next generate serves the unfaulted tokens."""
    _, _, _, _, vocab = _models("llama_tiny_test")
    prompts = _prompts(vocab, seed=12)
    hit = 1 if kind == "generator" else 2
    plan = {"rules": [{"site": "serve:execute", "kind": "delay",
                       "seconds": 1.0, "at": [hit]}]}
    res = []
    for side, f in (("jax", jfaults), ("port", tfaults)):
        gen = _build(kind, side)
        gen.warmup()
        want = gen.generate(prompts, max_new_tokens=NEW)[0]
        monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "400")
        f.install_plan(plan)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                first = _gen_outcome(lambda: gen.generate(
                    prompts, max_new_tokens=NEW))
            snaps = [s.breaker.snapshot()["consecutive_failures"]
                     for s in _sessions(gen)]
            time.sleep(1.2)  # the abandoned body finishes
            second = _gen_outcome(lambda: gen.generate(
                prompts, max_new_tokens=NEW))
        finally:
            f.clear_plan()
            monkeypatch.delenv("MXNET_SERVE_TIMEOUT_MS")
        res.append((first, snaps, second == ("ok", want)))
    assert res[0] == res[1]
    assert res[1][0] == ("503", False, False, True)
    assert sum(res[1][1]) == 1 and res[1][2]


def test_drain_waits_for_and_refuses_graph_replays(_no_plan):
    """Draining a generator's session waits for a super-step replay in
    flight (the replay counts on the session's admission gate) and then
    refuses the next one with a 503 ``draining``; resume reopens both."""
    _, _, port, _, vocab = _models("llama_tiny_test")
    prompts = _prompts(vocab, seed=13)
    gen = Generator(port, max_seq=64, batch_buckets=(2,),
                    prompt_buckets=(16,), decode_path="pallas",
                    multistep=True, decode_steps=8)
    gen.warmup()
    want = gen.generate(prompts, max_new_tokens=5)[0]  # one super-step
    plan = tfaults.install_plan({"rules": [
        {"site": "serve:execute", "kind": "delay", "seconds": 0.5,
         "at": [1]}]})
    got = []
    th = threading.Thread(target=lambda: got.append(
        gen.generate(prompts, max_new_tokens=5)[0]))
    th.start()
    t_end = time.monotonic() + 10
    while plan.fired_total() == 0 and time.monotonic() < t_end:
        time.sleep(0.005)
    assert gen.session.health()["inflight"] == 1
    assert gen._msession.health()["inflight"] == 1
    assert gen.session.drain(timeout=0.05) is False
    assert gen.session.drain(timeout=10) is True
    th.join(10)
    assert got == [want]
    zeros = np.zeros(2, np.int32)
    with pytest.raises(ServiceUnavailable, match="draining"):
        gen.decode_super(zeros, zeros + 1, 8, zeros, zeros,
                         np.zeros(2, np.float32), zeros,
                         np.full((2, _STOP_WIDTH), -1, np.int32),
                         np.zeros(2, np.uint32), gen._fresh_cache(2))
    assert not gen._msession.ready()
    gen.session.resume()
    assert gen._msession.ready()
    assert gen.generate(prompts, max_new_tokens=5)[0] == want
    gen.assert_no_recompiles()
