"""The port's continuous-batching engine (``serve.ContinuousEngine``)
against the JAX package's (``mxnet_tpu/serve/scheduler.py``).

Greedy tokens are held to the JAX engine on the same weights (copied
through numpy with ``load_reference_params``), on the ``pallas`` and
``int8`` rungs (not against the JAX ``baseline`` rung, whose compiler
options the installed JAX refuses; the port's ``baseline`` engine is held
to its own baseline ``Generator`` in ``test_torch_stable.py``),
single-step and multi-step at N = 8 and N = 1, with prompts shorter than, equal to and
longer than one prefill chunk, and through a prefix-cache hit. The rest
holds the engine's serving contract on the CPU: admit/retire churn with no
new signature and every page recycled, mid-decode deadlines, pool
exhaustion, shutdown, decode faults, idempotency keys and the metrics.
Every wait has a timeout, and every engine is closed by ``with`` or
``finally``.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models.llama import get_llama as jax_get_llama
from mxnet_tpu.profiler import attribution as jattr
from mxnet_tpu.profiler import trace as jtrace
from mxnet_tpu.serve import ContinuousEngine as JaxEngine
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_llama, load_reference_params
from mxnet_tpu_torch.profiler import attribution as tattr
from mxnet_tpu_torch.profiler import trace as ttrace
from mxnet_tpu_torch.resilience import faults
from mxnet_tpu_torch.serve import (ContinuousEngine, DeadlineExceeded,
                                   Generator, ServiceUnavailable)

WAIT = 60  # seconds any one future may take
# max_seq 64 in pages of 16; chunk 16: prompts of 3 (shorter than a
# chunk), 16 (one chunk exactly), 20 and 37 (two and three chunks)
ENG_KW = dict(max_seq=64, num_slots=4, page_size=16, prefill_chunk=16)
LENS = (3, 16, 20, 37)
MODES = [(False, 1), (True, 8), (True, 1)]
MODE_IDS = ["single", "multi8", "multi1"]

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


def _prompts(vocab, seed, lens=LENS):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, size=n)] for n in lens]


def _serve(eng, prompts, max_new=10, **kw):
    futs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    return [f.result(timeout=WAIT)["tokens"] for f in futs]


def _engine(port, multistep=False, steps=8, **kw):
    kw = dict(ENG_KW, **kw)
    return ContinuousEngine(port, multistep=multistep, decode_steps=steps,
                            **kw)


def _batch1(port, prompts, max_new, rung="pallas"):
    """Each prompt through a batch-1 single-step Generator."""
    gen = Generator(port, max_seq=64, batch_buckets=(1,),
                    prompt_buckets=(64,), decode_path=rung)
    return [gen.generate([p], max_new_tokens=max_new)[0][0]
            for p in prompts]


def _recycled(eng):
    st = eng.stats()["pool"]
    return st["pages_owned"] == 0 and st["pages_used"] == 0


# ---------------------------------------------------------------------------
# greedy tokens against the JAX engine
# ---------------------------------------------------------------------------


def _against_jax(config, rung, multistep, steps, seed):
    net, port, vocab = _models(config)
    prompts = _prompts(vocab, seed)
    kw = dict(ENG_KW, decode_path=rung, multistep=multistep,
              decode_steps=steps)
    with JaxEngine(net, name=f"tcb_{config}_{rung}_{multistep}_{steps}",
                   **kw) as je:
        want = [[int(t) for t in o] for o in _serve(je, prompts)]
    with ContinuousEngine(port, **kw) as eng:
        got = _serve(eng, prompts)
        eng.assert_no_recompiles()
        assert _recycled(eng)
        stats = eng.stats()
    assert got == want
    assert [len(o) for o in got] == [10] * len(prompts)
    if multistep:
        assert stats["multistep"]["signatures"] == (4 if steps > 1 else 2)
        assert stats["signatures"] == 1          # the (1, chunk) prefill
    else:
        assert stats["signatures"] == 2          # + the (4, 1) decode


@pytest.mark.parametrize("multistep,steps", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("rung", ["pallas", "int8"])
def test_greedy_tokens_identical_to_jax_engine(rung, multistep, steps):
    _against_jax("llama_tiny_test", rung, multistep, steps, seed=1)


@pytest.mark.parametrize("rung,multistep,steps",
                         [("pallas", False, 1), ("int8", True, 8)],
                         ids=["pallas-single", "int8-multi8"])
def test_greedy_tokens_identical_to_jax_engine_12l(rung, multistep, steps):
    _against_jax("llama_serve_12l_test", rung, multistep, steps, seed=2)


def test_prefix_hit_tokens_identical_to_miss_and_jax():
    """A second prompt sharing two full pages with a retired one matches
    them in the trie, prefills only its tail at start_pos = 16, and gives
    the tokens of a cache-off engine and of the JAX prefix engine."""
    net, port, vocab = _models()
    rng = np.random.RandomState(3)
    shared = [int(t) for t in rng.randint(1, vocab, size=16)]
    a = shared + [int(t) for t in rng.randint(1, vocab, size=5)]
    b = shared + [int(t) for t in rng.randint(1, vocab, size=9)]
    kw = dict(ENG_KW, page_size=8, prefill_chunk=8, multistep=True,
              decode_steps=4)
    with ContinuousEngine(port, **kw) as off:
        want = [_serve(off, [p])[0] for p in (a, b)]
    with JaxEngine(net, name="tcb_prefix", prefix_cache=True, **kw) as je:
        jwant = [[int(t) for t in _serve(je, [p])[0]] for p in (a, b)]
    with ContinuousEngine(port, prefix_cache=True, **kw) as eng:
        got = [_serve(eng, [p])[0] for p in (a, b)]
        snap = eng.metrics.snapshot()
        st = eng.stats()
        eng.assert_no_recompiles()
    assert got == want == jwant
    assert snap["prefix_hits"] == 1 and snap["prefix_tokens_skipped"] == 16
    assert st["pool"]["pages_owned"] == 0
    assert st["pool"]["pages_used"] == st["prefix"]["pages_held"] > 0


# ---------------------------------------------------------------------------
# the serving contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_churn_keeps_signatures_and_recycles_every_page(multistep):
    """>= 100 admit/retire cycles through 2 slots: outputs equal a
    batch-1 Generator's, no signature or graph is new after warmup, and
    every page returns to the free list."""
    _, port, vocab = _models()
    prompts = _prompts(vocab, 4, lens=(2, 9, 17, 30, 5, 12))
    budgets = (1, 3, 2, 5, 4, 1)
    want = {}
    for i, p in enumerate(prompts):
        want[i] = _batch1(port, [p], budgets[i])[0]
    with _engine(port, multistep=multistep, steps=4, num_slots=2,
                 max_queue=128) as eng:
        sigs = eng.stats()["signatures"]
        futs = [(i % 6, eng.submit(prompts[i % 6],
                                   max_new_tokens=budgets[i % 6]))
                for i in range(102)]
        for i, f in futs:
            assert f.result(timeout=WAIT)["tokens"] == want[i]
        eng.assert_no_recompiles()
        st = eng.stats()
        assert st["signatures"] == sigs
        assert st["requests"] == 102 and st["errors"] == 0
        assert _recycled(eng)
        assert st["pool"]["high_water"] <= 2 * 4


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_deadline_mid_decode_keeps_partial_tokens(multistep):
    """A slow decode (an injected 50 ms delay a visit) against a 500 ms
    deadline: the request settles with DeadlineExceeded carrying the
    tokens generated so far, a prefix of the undisturbed output."""
    _, port, vocab = _models()
    prompt = _prompts(vocab, 5, lens=(6,))[0]
    with _engine(port, multistep=multistep, steps=2) as eng:
        full = _serve(eng, [prompt], max_new=40)[0]
        faults.install_plan({"rules": [{"site": "serve:decode",
                                        "kind": "delay", "seconds": 0.05,
                                        "prob": 1.0}]})
        try:
            f = eng.submit(prompt, max_new_tokens=40, deadline_ms=500)
            with pytest.raises(DeadlineExceeded) as ei:
                f.result(timeout=WAIT)
        finally:
            faults.clear_plan()
        eng.assert_no_recompiles()
        assert _recycled(eng)
    part = ei.value.partial
    assert ei.value.status == 504
    assert 1 <= len(part) < 40 and part == full[:len(part)]
    assert eng.metrics.snapshot()["deadline_expired"].get("decode") == 1


def test_pool_exhaustion_requeues_instead_of_failing():
    """A pool with room for one request at a time: the others wait at the
    queue front as PoolExhausted backpressure and all complete with the
    batch-1 tokens."""
    _, port, vocab = _models()
    prompts = _prompts(vocab, 6, lens=(10, 20, 7, 14))
    want = _batch1(port, prompts, 8)
    # 16-token pages; each request needs 2 (prompt + 8 <= 32) of 3 usable
    with _engine(port, num_pages=4) as eng:
        got = _serve(eng, prompts, max_new=8)
        st = eng.stats()
    assert got == want
    assert st["pool"]["exhausted_count"] > 0 and st["errors"] == 0
    assert st["pool"]["pages_owned"] == 0


def test_close_fails_live_and_queued_with_503():
    """Driven step by step (no scheduler thread): one request is live in
    the only slot, two are queued; close() settles all three with 503."""
    _, port, vocab = _models()
    eng = _engine(port, num_slots=1)
    try:
        eng.warmup()
        futs = [eng.submit(p, max_new_tokens=8)
                for p in _prompts(vocab, 7, lens=(5, 6, 7))]
        eng.step()          # admits the first, prefills it, one decode
        assert eng.stats()["slots_live"] == 1
    finally:
        eng.close()
    for i, f in enumerate(futs):
        with pytest.raises(ServiceUnavailable) as ei:
            f.result(timeout=WAIT)
        assert ei.value.status == 503
        assert ("mid-request" if i == 0 else "before dispatch") \
            in str(ei.value)
    assert _recycled(eng)


@pytest.mark.parametrize("multistep", [False, True], ids=["single", "multi"])
def test_decode_fault_fails_that_step_and_engine_keeps_serving(multistep):
    """A fatal serve:decode fault on the second decode visit fails the
    two requests decoding in it; the next requests are served with the
    batch-1 tokens."""
    _, port, vocab = _models()
    prompts = _prompts(vocab, 8, lens=(4, 9))
    want = _batch1(port, prompts, 6)
    eng = _engine(port, multistep=multistep, steps=2)
    try:
        eng.warmup()
        faults.install_plan({"rules": [{"site": "serve:decode",
                                        "kind": "fatal", "at": [1]}]})
        try:
            futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            for _ in range(6):
                eng.step()
        finally:
            faults.clear_plan()
        for f in futs:
            with pytest.raises(faults.InjectedFaultError):
                f.result(timeout=WAIT)
        eng.start()
        assert _serve(eng, prompts, max_new=6) == want
        eng.assert_no_recompiles()
    finally:
        eng.close()
    assert eng.metrics.snapshot()["errors"] == 2
    assert _recycled(eng)


def test_prefill_fault_fails_only_that_request():
    """A fatal serve:execute fault in the second request's prefill chunk
    fails that request; the request already decoding completes with the
    batch-1 tokens. The third visit of the site is that chunk: the first
    step prefills the first request and runs its first super-step, whose
    replay passes the site too (as the JAX engine's super-step session
    does)."""
    _, port, vocab = _models()
    prompts = _prompts(vocab, 13, lens=(5, 9))
    want = _batch1(port, prompts[:1], 6)[0]
    eng = _engine(port, multistep=True, steps=2)
    try:
        eng.warmup()
        plan = faults.install_plan({"rules": [{"site": "serve:execute",
                                               "kind": "fatal", "at": [2]}]})
        try:
            futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            for _ in range(8):
                eng.step()
        finally:
            faults.clear_plan()
        assert plan.fired_total() == 1
        assert futs[0].result(timeout=WAIT)["tokens"] == want
        with pytest.raises(faults.InjectedFaultError):
            futs[1].result(timeout=WAIT)
    finally:
        eng.close()
    assert _recycled(eng)


def test_idempotency_key_settles_exactly_once():
    _, port, vocab = _models()
    prompt = _prompts(vocab, 9, lens=(8,))[0]
    with _engine(port) as eng:
        f1 = eng.submit(prompt, max_new_tokens=5, key="req-1")
        f2 = eng.submit(prompt, max_new_tokens=5, key="req-1")
        r = f1.result(timeout=WAIT)
        f3 = eng.submit([1, 2, 3], max_new_tokens=9, key="req-1")
        st = eng.stats()
    assert f2 is f1 and f3 is f1 and f3.result(timeout=WAIT) is r
    assert st["duplicate_submits"] == 2 and st["requests"] == 1
    assert r["tokens"] == _batch1(port, [prompt], 5)[0]


def test_metrics_snapshot_has_ttft_itl_and_kv_gauges():
    _, port, vocab = _models()
    with _engine(port, multistep=True, steps=4) as eng:
        _serve(eng, _prompts(vocab, 10), max_new=9)
        snap = eng.metrics.snapshot()
        st = eng.stats()
    for k in ("ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms", "itl_p50_ms",
              "itl_p99_ms", "kv_pages_used", "kv_pages_free",
              "slot_occupancy", "tokens_s", "queue_depth"):
        assert k in snap, k
    assert snap["ttft_p50_ms"] > 0 and snap["itl_p50_ms"] > 0
    assert snap["requests"] == 4 and snap["tokens"] == 4 * 9
    assert snap["kv_pages_free"] == st["pool"]["pages_free"]
    assert snap["slots_total"] == 4 and snap["decode_path"] == "pallas"
    assert snap["kv_cache_bytes"] == st["pool"]["nbytes"]


def _attributed_run(Engine, model, attr, trace, prompts, name, **kw):
    """Serve ``prompts`` with attribution and tracing on, stepping the
    scheduler inline (no thread, so both engines take the same visits);
    returns the ledger, the metrics, the requests' critical-path reports
    and the ``serve::decode_step`` spans' args and walls."""
    attr.enable()
    trace.reset()
    trace.enable()
    eng = Engine(model, name=name, **dict(ENG_KW, **kw))
    try:
        futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for _ in range(200):
            if all(f.done() for f in futs):
                break
            eng.step()
        toks = [f.result(timeout=WAIT)["tokens"] for f in futs]
        ledger, metrics = eng.ledger.snapshot(), eng.metrics.snapshot()
        tids = [s["trace_id"] for s in trace.summaries(limit=50)
                if s["name"].startswith("serve.request")]
        reports = [attr.report(t) for t in tids]
        spans = [sp for t in tids for sp in trace.summary(t)["spans"]
                 if sp["name"] == "serve::decode_step"]
    finally:
        eng.close()
        attr.disable()
        trace.disable()
        trace.reset()
    return toks, ledger, metrics, reports, spans


@pytest.mark.parametrize("multistep,steps", MODES, ids=MODE_IDS)
def test_attribution_ledger_matches_jax_engine(multistep, steps):
    """With attribution on, the engine's ledger and the requests'
    critical-path reports count the JAX engine's visits, tokens and
    prefill chunks on the same calls; each decode span's four phases
    partition its wall, and the gauges reach ``ServeMetrics``. Times
    are each engine's own. Nothing feeds the wait phase in the port."""
    net, port, vocab = _models()
    prompts = _prompts(vocab, 3)
    kw = dict(decode_path="pallas", multistep=multistep, decode_steps=steps)
    j = _attributed_run(JaxEngine, net, jattr, jtrace, prompts,
                        f"jattr_{multistep}_{steps}", **kw)
    t = _attributed_run(ContinuousEngine, port, tattr, ttrace, prompts,
                        f"tattr_{multistep}_{steps}", **kw)
    assert t[0] == [[int(x) for x in o] for o in j[0]]
    counted = ("steps", "window", "tokens", "tokens_per_visit")
    assert {k: t[1][k] for k in counted} == {k: j[1][k] for k in counted}
    # the first token of each request comes from its prefill
    assert t[1]["steps"] > 0 and t[1]["tokens"] == 4 * 9
    assert t[1]["wait_ms"] == 0.0
    assert 0.0 < t[1]["host_overhead_fraction"] <= 1.0
    assert t[1]["device_ms_per_token"] > 0.0
    assert t[2]["host_overhead_fraction"] == pytest.approx(
        t[1]["host_overhead_fraction"])
    assert t[2]["device_ms_per_token"] == pytest.approx(
        t[1]["device_ms_per_token"])
    shape = ("finished", "prefill_chunks", "decode_steps", "ledger_steps",
             "ledger_tokens")
    assert len(t[3]) == len(prompts)
    assert [{k: r[k] for k in shape} for r in t[3]] == \
        [{k: r[k] for k in shape} for r in j[3]]
    assert all(r["ledger_steps"] == r["decode_steps"] > 0 for r in t[3])
    assert len(t[4]) == len(j[4]) > 0
    for sp in t[4]:
        a = sp["args"]
        parts = sum(a[k] for k in ("host_ms", "dispatch_ms", "device_ms",
                                   "wait_ms"))
        assert abs(parts - sp["dur_ms"]) <= max(0.10 * sp["dur_ms"], 0.05), \
            (parts, sp["dur_ms"], a)


def test_mixed_greedy_and_sampled_lanes():
    """Greedy lanes riding in a sampled super-step keep their greedy
    tokens; a sampled stream under a fixed seed is the same at N = 8 and
    N = 1 (keyed by the admission seed and the position)."""
    _, port, vocab = _models()
    prompts = _prompts(vocab, 11)
    want = _batch1(port, prompts[:2], 12)
    outs = []
    for steps in (8, 1):
        trandom.seed(21)
        with _engine(port, multistep=True, steps=steps) as eng:
            futs = [eng.submit(p, max_new_tokens=12,
                               temperature=0.0 if i < 2 else 0.8, top_k=5)
                    for i, p in enumerate(prompts)]
            eng_out = [f.result(timeout=WAIT)["tokens"] for f in futs]
            eng.assert_no_recompiles()
        assert eng_out[:2] == want
        outs.append(eng_out)
    assert outs[0] == outs[1]


def test_drain_resume_and_refusals():
    _, port, vocab = _models()
    with _engine(port) as eng:
        with pytest.raises(MXNetError, match="empty prompt"):
            eng.submit([])
        with pytest.raises(MXNetError, match="exceeds max_seq"):
            eng.submit([1] * 60, max_new_tokens=5)
        _serve(eng, _prompts(vocab, 12, lens=(4,)), max_new=3)
        assert eng.drain(timeout=WAIT)
        with pytest.raises(ServiceUnavailable, match="draining") as ei:
            eng.submit([1, 2], max_new_tokens=2)
        assert ei.value.retry_after_ms is not None
        eng.resume()
        assert len(_serve(eng, [[1, 2]], max_new=2)[0]) == 2


def test_steps_limit_degrades_under_a_tight_deadline():
    _, port, _ = _models()
    eng = _engine(port, multistep=True, steps=8)
    try:
        eng.warmup()
        assert eng._steps_limit([]) == 8                  # no estimate yet
        eng._itl_est = 0.05
        f = eng.submit([1, 2, 3], max_new_tokens=4, deadline_ms=100)
        eng.step()
        assert eng._steps_limit([0]) == 1
        for _ in range(20):
            if f.done():
                break
            eng.step()
        assert f.done()
    finally:
        eng.close()
    with _engine(port, multistep=True, steps=8) as eng:
        sigs = eng._msession.signature_count()
        eng._itl_est = 1000.0
        eng.submit([1, 2, 3], max_new_tokens=6,
                   deadline_ms=30_000).result(timeout=WAIT)
        assert eng._msession.signature_count() == sigs
        eng.assert_no_recompiles()


def test_flags_resolve_slots_and_chunk(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_SLOTS", "3")
    monkeypatch.setenv("MXNET_SERVE_PREFILL_CHUNK", "0")
    _, port, _ = _models()
    eng = ContinuousEngine(port, max_seq=64, page_size=16)
    try:
        assert eng.num_slots == 3 and eng.prefill_chunk == 16
    finally:
        eng.close()
