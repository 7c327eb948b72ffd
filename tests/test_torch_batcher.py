"""The port's admission queue and serving metrics (``serve.batcher``,
``serve.metrics``) against the JAX package's.

Both are host code copied from the JAX package, so the same scripted
submit sequences through the two ``DynamicBatcher``s, with the same stub
runners, must settle the same way: the same results, the same 503/504
classes and ``retry_after_ms`` shapes, the same shed order and the same
counts. ``TokenBucket``, ``percentile`` and ``ServeMetrics`` snapshots are
held to the JAX package's on the same observations. Scripts that depend
on the queue's state run with the flusher off (``start=False``) and drive
the consumer API (``take`` / ``settle_one`` / ``requeue`` /
``settle_expired``) by hand, so nothing races; every wait has a timeout.
"""
import time

import numpy as np
import pytest

from mxnet_tpu.serve import batcher as jbatcher
from mxnet_tpu.serve import metrics as jmetrics
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serve import batcher as tbatcher
from mxnet_tpu_torch.serve import metrics as tmetrics

WAIT = 30
SIDES = {"jax": (jbatcher, jmetrics), "port": (tbatcher, tmetrics)}
COUNTS = ("requests", "errors", "rejects", "batches", "sheds",
          "deadline_expired", "goodput", "late_completions", "rate_limited",
          "queue_depth")


def _outcome(fut):
    """A settled future as a comparable value."""
    try:
        return ("ok", fut.result(timeout=WAIT))
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, getattr(e, "status", None),
                getattr(e, "retry_after_ms", None) is None)


def _submit(b, payload, **kw):
    """Submit; a synchronous refusal is an outcome too."""
    try:
        return b.submit(payload, **kw)
    except Exception as e:  # noqa: BLE001
        return ("raised", type(e).__name__, getattr(e, "status", None),
                getattr(e, "retry_after_ms", None) is None)


def _counts(b):
    snap = b.stats()
    return {k: snap[k] for k in COUNTS} | {
        "duplicate_submits": b.duplicate_submits}


def _both(script):
    """Run ``script(batcher_module)`` on both sides; returns both results."""
    return [script(mod) for mod, _ in SIDES.values()]


def test_flush_on_full_and_on_timeout():
    def script(mod):
        sizes = []

        def runner(xs):
            sizes.append(len(xs))
            return [x * 2 for x in xs]

        with mod.DynamicBatcher(runner, max_batch_size=4, timeout_ms=200,
                                name="t_full") as b:
            futs = [b.submit(i) for i in range(4)]
            out = [_outcome(f) for f in futs]
            out.append(_outcome(b.submit(10)))   # alone: the timeout
            return out, sizes, _counts(b)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[0][:4] == [("ok", 0), ("ok", 2), ("ok", 4), ("ok", 6)]
    assert port_side[1] == [4, 1]


def test_runner_failures_fail_their_batch_only():
    def script(mod):
        calls = []

        def runner(xs):
            calls.append(list(xs))
            if len(calls) == 1:
                raise RuntimeError("boom")
            return [ValueError("bad row") if x == 3 else x for x in xs]

        with mod.DynamicBatcher(runner, max_batch_size=2, timeout_ms=5,
                                name="t_fail") as b:
            out = [_outcome(f) for f in [b.submit(1), b.submit(2)]]
            out += [_outcome(f) for f in [b.submit(3), b.submit(4)]]
            return out, _counts(b)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert [o[0] for o in port_side[0]] == ["RuntimeError", "RuntimeError",
                                            "ValueError", "ok"]


def test_queue_cap_shed_order_and_batch_share(monkeypatch):
    """max_queue 4, batch share 0.5: two batch-class requests fill their
    share (the third sheds on share), two interactive fill the queue, the
    next two interactive displace the batch requests newest first, and
    a fifth interactive is rejected; take() hands out in order."""
    monkeypatch.setenv("MXNET_SERVE_BATCH_QUEUE_SHARE", "0.5")

    def script(mod):
        b = mod.DynamicBatcher(None, max_queue=4, name="t_shed",
                               start=False)
        try:
            futs = [_submit(b, "b0", priority="batch"),
                    _submit(b, "b1", priority="batch"),
                    _submit(b, "b2", priority="batch"),
                    _submit(b, "i0"), _submit(b, "i1"), _submit(b, "i2"),
                    _submit(b, "i3"), _submit(b, "i4")]
            queued = [p.payload for p in b._queue]
            batch, expired = b.take(3)
            order = [p.payload for p in batch]
            for p in batch:
                b.settle_one(p, result=p.payload.upper())
        finally:
            b.close(1.0)
        rest = [_outcome(f) if not isinstance(f, tuple) else f
                for f in futs]
        return queued, order, expired, rest, _counts(b)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    queued, order, expired, rest, counts = port_side
    assert queued == ["i0", "i1", "i2", "i3"]
    assert order == ["i0", "i1", "i2"] and expired == []
    assert rest[0] == rest[1] == ("ServiceUnavailable", 503, False)  # shed
    assert rest[2] == ("raised", "ServiceUnavailable", 503, False)  # share
    assert rest[3:6] == [("ok", "I0"), ("ok", "I1"), ("ok", "I2")]
    assert rest[6] == ("ServiceUnavailable", 503, True)    # closed, queued
    assert rest[7] == ("raised", "ServiceUnavailable", 503, False)  # full
    assert counts["sheds"] == {"batch": 3} and counts["rejects"] == 1


def test_deadlines_admission_queue_and_settle():
    def script(mod):
        b = mod.DynamicBatcher(None, name="t_dl", start=False)
        try:
            out = [_submit(b, "late", deadline_ms=1e-6)]
            f_q = b.submit("queued", deadline_ms=5)
            f_ok = b.submit("ok", deadline_ms=60_000)
            f_x = b.submit("exec", deadline_ms=200)
            time.sleep(0.01)
            batch, expired = b.take(4)
            out.append(([p.payload for p in batch],
                        [p.payload for p in expired]))
            b.settle_expired(expired)
            batch, _ = b.take(4)
            time.sleep(0.25)
            for p in batch:
                b.settle_one(p, result=p.payload)
            out += [_outcome(f) for f in (f_q, f_ok, f_x)]
            return out, _counts(b)
        finally:
            b.close(1.0)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    out = port_side[0]
    assert out[0][:3] == ("raised", "DeadlineExceeded", 504)
    assert out[1] == ([], ["queued"])
    assert out[2][:2] == ("DeadlineExceeded", 504)
    assert out[3] == ("ok", "ok") and out[4][:2] == ("DeadlineExceeded", 504)


def test_idempotency_requeue_drain_resume_and_close():
    def script(mod):
        b = mod.DynamicBatcher(None, name="t_keys", start=False)
        out = []
        try:
            f1 = b.submit("x", key="k")
            out.append(b.submit("y", key="k") is f1)
            batch, _ = b.take(1)
            b.requeue(batch[0])              # back to the queue front
            out.append([p.payload for p in b._queue])
            out.append(b.drain(timeout=0.01))          # not quiesced
            out.append(_submit(b, "z"))                # draining: 503
            b.resume()
            batch, _ = b.take(2)
            b.settle_one(batch[0], result="done")
            out.append(_outcome(f1))
            out.append(b.submit("again", key="k") is f1)
            f2 = b.submit("w")
        finally:
            b.close(1.0)
        out.append(_outcome(f2))
        out.append(_submit(b, "after"))                # closed: structural
        return out, _counts(b)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    out, counts = port_side
    assert out[:3] == [True, ["x"], False]
    assert out[3] == ("raised", "ServiceUnavailable", 503, False)
    assert out[4] == ("ok", "done") and out[5] is True
    assert out[6] == ("ServiceUnavailable", 503, True)
    assert out[7] == ("raised", "ServiceUnavailable", 503, True)
    assert counts["duplicate_submits"] == 2


def test_rate_limit_and_queue_fault():
    def script(mod, faults):
        b = mod.DynamicBatcher(None, name="t_rate", start=False)
        b.rate_limiter = mod.TokenBucket(1e-6, 2)
        out = [_submit(b, i, priority="batch") for i in range(3)]
        out = [o if isinstance(o, tuple) else "queued" for o in out]
        faults.install_plan({"rules": [{"site": "serve:queue",
                                        "kind": "transient", "at": [1]}]})
        try:
            res = [_submit(b, "q0"), _submit(b, "q1"), _submit(b, "q2")]
        finally:
            faults.clear_plan()
        out += [o if isinstance(o, tuple) else "queued" for o in res]
        b.close(1.0)
        return out, _counts(b)

    from mxnet_tpu.resilience import faults as jfaults

    jax_side = script(jbatcher, jfaults)
    port_side = script(tbatcher, tfaults)
    assert jax_side == port_side
    out = port_side[0]
    assert out[:2] == ["queued", "queued"]
    assert out[2] == ("raised", "ServiceUnavailable", 503, False)
    assert out[3] == "queued" and out[5] == "queued"
    assert out[4][:2] == ("raised", "TransientFaultError")
    assert port_side[1]["rate_limited"] == 1


def test_token_bucket_on_a_fake_clock(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    runs = []
    for mod in (jbatcher, tbatcher):
        clock[0] = 100.0
        tb = mod.TokenBucket(rate=2.0, burst=3)
        seq = []
        for dt in (0, 0, 0, 0, 0.2, 0.3, 0.5, 0, 5.0, 0, 0, 0, 0):
            clock[0] += dt
            seq.append(tb.take())
        seq.append(mod.TokenBucket(0, 1).take())
        runs.append(seq)
    assert runs[0] == runs[1]
    assert runs[1][:4] == [True, True, True, False]


def test_percentile_matches_reference():
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 7, 100, 1001):
        xs = list(rng.exponential(3.0, size=n))
        for pct in (1, 25, 50, 90, 95, 99, 99.9, 100):
            assert tmetrics.percentile(xs, pct) == \
                jmetrics.percentile(xs, pct)
    assert tmetrics.percentile([1, 2], 50) == 1


def _observe(m, rng):
    for i in range(300):
        m.observe_request(float(rng.uniform(0, 5)), float(rng.uniform(0, 50)),
                          ok=bool(i % 7), priority=("interactive", "batch")[
                              i % 2], deadline_ok=bool(i % 11))
    for i in range(40):
        m.observe_batch(int(rng.randint(1, 9)), 8)
        m.observe_ttft(float(rng.uniform(1, 100)), "interactive")
        m.observe_itl(float(rng.uniform(5, 80)), live=int(rng.randint(1, 5)),
                      tokens=int(rng.randint(1, 9)))
        m.observe_tokens(int(rng.randint(1, 40)), float(rng.uniform(.1, 2)))
        m.observe_prefix(int(rng.choice([0, 16, 32])))
    m.observe_reject()
    m.observe_shed("batch", reason="rate")
    m.observe_shed("batch")
    m.observe_deadline("decode", "interactive")
    m.observe_deadline("queue", "batch")
    m.observe_swap("warm", 0.1)
    m.set_queue_depth(3)
    m.set_kv_pages(10, 22)
    m.set_slot_occupancy(3, 4)
    m.set_prefix_gauges(2, 5, 1)
    m.set_kv_cache_bytes(123456)
    m.set_decode_path("int8")
    m.set_attribution(0.25, 17.5)


def test_serve_metrics_snapshot_matches_reference():
    snaps = []
    for mod in (jmetrics, tmetrics):
        m = mod.ServeMetrics("t_metrics", window=128)
        _observe(m, np.random.RandomState(1))
        snaps.append((m.snapshot(), m.itl_samples(),
                      m.latency_percentiles()))
    assert snaps[0] == snaps[1]
    snap = snaps[1][0]
    assert snap["slot_occupancy"] == 0.75 and snap["rate_limited"] == 1
    assert snap["prefix_hit_rate"] > 0 and snap["itl_p99_ms"] > 0


def test_metrics_window_flag(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_METRICS_WINDOW", "5")
    m = tmetrics.ServeMetrics("t_window")
    for i in range(20):
        m.observe_ttft(float(i))
    assert m.snapshot()["ttft_p50_ms"] == 17.0


@pytest.mark.parametrize("priority", ["nope", "INTERACTIVE"])
def test_unknown_priority_raises_on_both(priority):
    for mod, _ in SIDES.values():
        b = mod.DynamicBatcher(None, name="t_prio", start=False)
        try:
            with pytest.raises(Exception, match="unknown priority"):
                b.submit(1, priority=priority)
        finally:
            b.close(1.0)
    assert tbatcher.PRIORITIES == jbatcher.PRIORITIES
