"""The port's ``resilience.retry`` (classification, backoff, the watchdog
and its orphans, the circuit breaker) and the resilience wiring of its
``serve.InferenceSession`` (breaker, watchdog, drain/resume/swap, health
and readiness probes) against the JAX package's on the same scripted
calls.

The retry module is a host-only copy, so the same calls must give the
same outcomes, counters and breaker readouts on both sides. The session
comparison runs a JAX ``InferenceSession`` built with
``deterministic=False`` (the JAX ``baseline`` compile options do not run
on the installed JAX) over a ``gluon.nn.Dense`` and the port's over a
``torch.nn.Linear`` holding the same weights.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon
from mxnet_tpu.profiler import recorder as jrec
from mxnet_tpu.resilience import counters as jcounters
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.resilience import retry as jretry
from mxnet_tpu.serve import InferenceSession as JaxSession
from mxnet_tpu.serve import ServiceUnavailable as JaxUnavailable
from mxnet_tpu_torch.profiler import recorder as trec
from mxnet_tpu_torch.resilience import counters as tcounters
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.resilience import retry as tretry
from mxnet_tpu_torch.serve import InferenceSession, ServiceUnavailable

SIDES = [dict(retry=jretry, faults=jfaults, counters=jcounters),
         dict(retry=tretry, faults=tfaults, counters=tcounters)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """No fault plan, zeroed counters, both recorders on and empty
    (another test in the process may have turned one off), dumps under
    ``tmp_path``."""
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(tmp_path))
    for s, rec in zip(SIDES, (jrec, trec)):
        s["counters"].reset()
        s["faults"].clear_plan()
        monkeypatch.setattr(rec, "ENABLED", True)
        rec.reset()
    yield
    for s, rec in zip(SIDES, (jrec, trec)):
        s["faults"].clear_plan()
        rec.reset()


def _both(fn):
    return [fn(s) for s in SIDES]


def test_is_transient_classification():
    def script(s):
        f, r = s["faults"], s["retry"]
        excs = [f.TransientFaultError("x"), f.InjectedFaultError("x"),
                f.ChipLostError("x", replica=1), r.CollectiveTimeoutError("x"),
                RuntimeError("RESOURCE_EXHAUSTED: busy"),
                RuntimeError("Connection reset by peer"),
                RuntimeError("UNAVAILABLE: socket"), ValueError("shape"),
                RuntimeError("CUDA error: an illegal memory access")]
        return [r.is_transient(e) for e in excs] + [
            r.is_transient(f.SimulatedWorkerDeath("x"))]

    jax_side, port_side = _both(script)
    assert jax_side == port_side == [True, False, False, False, True, True,
                                     True, False, False, False]


def test_call_with_retry_counts_and_backoff():
    """Transient failures retry up to the policy's budget with the same
    backoff curve; fatal and worker-death failures raise at once."""
    def script(s):
        f, r = s["faults"], s["retry"]
        pol = r.RetryPolicy(max_retries=2, base_delay_s=1e-4,
                            max_delay_s=3e-4)
        log = []

        def flaky(n_fail, exc):
            calls = [0]

            def fn():
                calls[0] += 1
                if calls[0] <= n_fail:
                    raise exc
                return calls[0]
            return fn, calls

        out = []
        fn, calls = flaky(2, f.TransientFaultError("t"))
        out.append(r.call_with_retry(
            fn, "site", pol, on_retry=lambda a, e: log.append(a)))
        for n, exc in ((3, f.TransientFaultError("t")),
                       (1, f.InjectedFaultError("x")),
                       (1, ValueError("bug"))):
            fn, calls = flaky(n, exc)
            with pytest.raises(type(exc)):
                r.call_with_retry(fn, "site", pol)
            out.append(calls[0])
        fn, calls = flaky(1, f.SimulatedWorkerDeath("die"))
        with pytest.raises(f.SimulatedWorkerDeath):
            r.call_with_retry(fn, "site", pol)
        out.append(calls[0])
        return (out, log, r.retry_count(), [pol.delay(i) for i in range(4)],
                r.compile_policy().max_retries,
                r.collective_policy().base_delay_s)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[0] == [3, 3, 1, 1, 1] and port_side[2] == 4


def test_watchdog_timeouts_and_orphans():
    """Inline at timeout 0; a body's result and exception cross back from
    the watchdog thread; a slow body times out, counts one orphan that
    stays live until the body ends, and dumps the flight recorder."""
    def script(s):
        r, c = s["retry"], s["counters"]
        ident = []
        assert r.run_with_watchdog(
            lambda: ident.append(threading.get_ident()) or 7, 0) == 7
        inline = ident[0] == threading.get_ident()
        got = r.run_with_watchdog(
            lambda: threading.current_thread().name, 5.0, site="s1")
        with pytest.raises(KeyError):
            r.run_with_watchdog(lambda: {}["k"], 5.0)
        # (orphans other tests left running count in "live": read deltas)
        live0 = r.watchdog_orphans()["live"]
        release = threading.Event()
        with pytest.warns(RuntimeWarning, match="watchdog abandoned"):
            with pytest.raises(r.CollectiveTimeoutError):
                r.run_with_watchdog(lambda: release.wait(5), 0.05,
                                    site="hang")
        during = r.watchdog_orphans()
        release.set()
        deadline = time.monotonic() + 5
        while r.watchdog_orphans()["live"] > live0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        return (inline, got, during["total"], during["live"] - live0,
                r.watchdog_orphans()["live"] - live0,
                c.get("resilience.watchdog_timeouts"))

    jax_side, port_side = _both(script)
    assert jax_side[0] and port_side[0]
    assert jax_side[1] == "mxtpu-watchdog[s1]" == port_side[1]
    assert jax_side[2:] == port_side[2:] == (1, 1, 0, 1)


def test_breaker_transitions_match():
    """closed -> open after K failures, call-count cooldown to half-open,
    one probe at a time, close on success / reopen on failure; the
    structured state and the live-breaker registry match."""
    script_ops = (["fail", "allow", "fail", "fail"] + ["allow"] * 4
                  + ["allow", "allow", "release", "allow", "fail"]
                  + ["allow"] * 4 + ["allow", "ok", "allow", "fail"])

    def script(s):
        r = s["retry"]
        b = r.CircuitBreaker(failure_threshold=3, cooldown_calls=4,
                             name="t:breaker")
        trace = []
        for op in script_ops:
            if op == "fail":
                b.record_failure()
            elif op == "ok":
                b.record_success()
            elif op == "release":
                b.release_probe()
            else:
                trace.append(b.allow())
            st = b.state
            trace.append((str(st), st(), b.snapshot()))
        return trace, r.breaker_states()["t:breaker"]

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[1]["trips"] == 2


# ---------------------------------------------------------------------------
# InferenceSession: breaker, watchdog, drain/swap, probes
# ---------------------------------------------------------------------------


def _dense_pair(seed=0, units=4):
    """A JAX Dense(3 -> units) and a torch Linear with its weights."""
    mx.random.seed(seed)
    jd = gluon.nn.Dense(units, in_units=3)
    jd.initialize()
    params = {k.split(".")[-1]: np.array(v.data().asnumpy())
              for k, v in jd.collect_params().items()}
    td = torch.nn.Linear(3, units)
    with torch.no_grad():
        td.weight.copy_(torch.from_numpy(params["weight"]))
        td.bias.copy_(torch.from_numpy(params["bias"]))
    return jd, td.eval()


def _sessions(name, seed=0):
    jd, td = _dense_pair(seed)
    js = JaxSession(jd, batch_buckets=(1, 4), name=f"j_{name}",
                    deterministic=False)
    ts = InferenceSession(td, batch_buckets=(1, 4), name=f"t_{name}",
                          device="cpu")
    return js, ts


def _outcome(fn):
    try:
        out = fn()
        return ("ok", np.round(np.asarray(
            out.asnumpy() if hasattr(out, "asnumpy") else out.numpy()), 5)
            .tolist())
    except (ServiceUnavailable, JaxUnavailable) as e:
        return ("503", "breaker" in str(e), "draining" in str(e),
                "MXNET_SERVE_TIMEOUT_MS" in str(e))
    except Exception as e:  # noqa: BLE001 -- the outcome is the class name
        return ("err", type(e).__name__)


def test_session_breaker_under_fault_plan_matches_jax():
    """A fatal ``serve:execute`` fault on the first 5 executions: the
    breaker opens after 3, denies each cooldown's 8 calls with a 503
    (never another route), goes half-open, reopens on the two failing
    probes and closes on the third — the same outcomes, breaker snapshots
    and readiness on both sides."""
    js, ts = _sessions("breaker")
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    js.warmup(x)
    ts.warmup(x)
    plan = {"rules": [{"site": "serve:execute", "kind": "fatal",
                       "times": 5}]}
    res = []
    for sess, f in ((js, jfaults), (ts, tfaults)):
        f.install_plan(plan)
        try:
            rows = []
            for _ in range(30):
                rows.append((_outcome(lambda: sess.predict(x)),
                             sess.breaker.snapshot(), sess.ready()))
        finally:
            f.clear_plan()
        h = sess.health()
        rows.append((h["state"], h["ready"], h["breaker"], h["rejects"]))
        res.append(rows)
    assert res[0] == res[1]
    outcomes = [r[0][0] for r in res[1][:30]]
    assert outcomes == (["err"] * 3 + ["503"] * 8 + ["err"] + ["503"] * 8
                        + ["err"] + ["503"] * 8 + ["ok"])
    assert trec.last_dump_path() is not None
    assert trec.last_dump_path().endswith("breaker_open.json")


def test_session_watchdog_timeout_is_503(monkeypatch):
    """``MXNET_SERVE_TIMEOUT_MS`` with a hung execution (a 0.3 s delay
    fault) gives a 503 naming the timeout and counts a breaker failure
    and an orphan, on both sides. The port's watchdog is off until the
    signature set is frozen (a kernel's first-use build is not a hang);
    the JAX session's warmup is watched, so both warm up before the
    timeout is set."""
    js, ts = _sessions("timeout")
    x = np.ones((1, 3), np.float32)
    js.warmup(x)
    ts.warmup(x)
    monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "50")
    plan = {"rules": [{"site": "serve:execute", "kind": "delay",
                       "seconds": 0.3, "times": 1}]}
    res = []
    for sess, f, r in ((js, jfaults, jretry), (ts, tfaults, tretry)):
        f.install_plan(plan)
        try:
            with pytest.warns(RuntimeWarning, match="watchdog abandoned"):
                first = _outcome(lambda: sess.predict(x))
            second = _outcome(lambda: sess.predict(x))
        finally:
            f.clear_plan()
        res.append((first, second, sess.breaker.snapshot(),
                    r.watchdog_orphans()["total"] >= 1))
    assert res[0] == res[1]
    assert res[1][0] == ("503", False, False, True)
    assert res[1][1][0] == "ok"
    # the port's warmup under the same timeout and a slow first call
    _, fresh = _sessions("timeout_warm")
    tfaults.install_plan(plan)
    try:
        assert fresh.warmup(x) == 2
    finally:
        tfaults.clear_plan()
    assert fresh.breaker.snapshot()["consecutive_failures"] == 0


def test_session_drain_swap_and_probes_match_jax():
    """drain → 503 "draining" and not ready → resume; a warm swap (same
    architecture) serves the new weights with no new signature; a cold
    swap (another width) re-warms from ``example``; the health payloads
    carry the same keys and values on both sides."""
    js, ts = _sessions("swap")
    x = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    res = []
    for sess, seed_new in ((js, 5), (ts, 5)):
        jd_new, td_new = _dense_pair(seed_new)
        jd_wide, td_wide = _dense_pair(seed_new, units=6)
        new, wide = (jd_new, jd_wide) if sess is js else (td_new, td_wide)
        rows = [sess.ready()]
        sess.warmup(x)
        h = sess.health()
        rows.append((sorted(h), h["state"], h["ready"], h["warm"]))
        rows.append(sess.drain(1.0))
        rows.append((sess.ready(), sess.health()["state"],
                     _outcome(lambda: sess.predict(x))))
        sess.resume()
        rows.append(sess.ready())
        rows.append(sess.swap(new))
        rows.append(_outcome(lambda: sess.predict(x)))
        sess.assert_no_recompiles()
        rows.append(sess.swap(wide, example=x))
        rows.append(_outcome(lambda: sess.predict(x)))
        sess.assert_no_recompiles()
        rows.append((sess.ready(), sess.metrics.snapshot()["swaps"]))
        res.append(rows)
    assert res[0] == res[1]
    assert res[1][5] == "warm" and res[1][7] == "cold"
    assert res[1][0] is False and res[1][4] is True
    stats = ts.stats()
    assert stats["cache"]["signatures"] == 2 and \
        stats["watchdog_orphans"]["total"] == 0
    assert stats["breaker"]["state"] == "closed"
