"""The port's ``profiler.export`` (one flat snapshot, Prometheus text, the
``/metrics`` ``/healthz`` ``/snapshot`` HTTP endpoint) and
``profiler.slo`` (declarative SLOs, multi-window burn rates, the
``slo_burn`` escalation, degraded-not-dead health) against the JAX
package's modules on the same scripted calls.

Both are host-only copies: the same observations must give the same burn
rates, states, dumps, snapshot keys and values, Prometheus lines and
health payloads. The health registries are swapped for empty ones per
test, so sessions other tests left alive are not probed.
"""
import json
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon
from mxnet_tpu.profiler import export as jexport
from mxnet_tpu.profiler import recorder as jrec
from mxnet_tpu.profiler import slo as jslo
from mxnet_tpu.resilience import counters as jcounters
from mxnet_tpu.serve import InferenceSession as JaxSession
from mxnet_tpu.serve import metrics as jmetrics
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.profiler import export as texport
from mxnet_tpu_torch.profiler import recorder as trec
from mxnet_tpu_torch.profiler import slo as tslo
from mxnet_tpu_torch.resilience import counters as tcounters
from mxnet_tpu_torch.serve import InferenceSession
from mxnet_tpu_torch.serve import metrics as tmetrics

SIDES = [dict(export=jexport, slo=jslo, rec=jrec, metrics=jmetrics,
              counters=jcounters),
         dict(export=texport, slo=tslo, rec=trec, metrics=tmetrics,
              counters=tcounters)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Both recorders on and empty (another test in the process may have
    turned one off), dumps under ``tmp_path``, empty health rolls."""
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(tmp_path))
    for s in SIDES:
        monkeypatch.setattr(s["rec"], "ENABLED", True)
        s["rec"].reset()
        s["counters"].reset()
        monkeypatch.setattr(s["export"], "_health_providers",
                            weakref.WeakSet())
    yield
    for s in SIDES:
        s["rec"].reset()


def _both(fn):
    return [fn(s) for s in SIDES]


# ---------------------------------------------------------------------------
# SLO
# ---------------------------------------------------------------------------


def test_slo_objectives_and_errors():
    def script(s):
        slo = s["slo"]
        objs = [slo.SLO("itl_p99_ms", 50.0, window=60.0),
                slo.SLO("ttft_p99_ms", 200.0, window=12.0, fast_window=2.0,
                        threshold=2.0),
                slo.SLO("goodput", 0.99), slo.SLO("error_rate", 0.05)]
        goods = [(o.good(value=49.0), o.good(value=51.0)) if
                 o.kind != "completion" else
                 (o.good(ok=False), o.good(ok=True, deadline_ok=False),
                  o.good(ok=True)) for o in objs]
        return [o.describe() for o in objs], goods, [o.budget for o in objs]

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    with pytest.raises(MXNetError, match="unknown SLO metric"):
        tslo.SLO("p50_ms", 1.0)


def test_burn_rates_edges_and_dumps_match():
    """A scripted stream of timestamped ITL/TTFT/completion events: the
    same rows at each evaluation, one ok->degraded edge and one
    ``slo_burn`` dump (edge-triggered), recovery to ok with no second
    dump, and the same snapshot and health fragments."""
    def script(s):
        slo, rec = s["slo"], s["rec"]
        mon = slo.SLOMonitor(
            "slo_t", [slo.SLO("itl_p99_ms", 20.0, window=10.0,
                              fast_window=2.0, threshold=5.0),
                      slo.SLO("error_rate", 0.1, window=10.0,
                              fast_window=2.0, threshold=2.0)],
            eval_interval=0.0, min_events=4)
        rows = []
        t = 100.0
        for i in range(12):                 # healthy
            mon.observe("itl_ms", 10.0, ts=t + i * 0.1)
            mon.observe("completion", ok=True, ts=t + i * 0.1)
        rows.append((mon.evaluate(t + 1.2), mon.state))
        for i in range(10):                 # slow tokens and errors
            mon.observe("itl_ms", 40.0, ts=t + 2 + i * 0.1)
            mon.observe("completion", ok=i % 2 == 0, ts=t + 2 + i * 0.1)
        rows.append((mon.evaluate(t + 3.0), mon.state, mon.health()))
        rows.append((mon.evaluate(t + 3.1), mon.state, mon.burns))
        for i in range(20):                 # clean again
            mon.observe("itl_ms", 5.0, ts=t + 20 + i * 0.1)
            mon.observe("completion", ok=True, ts=t + 20 + i * 0.1)
        rows.append((mon.evaluate(t + 22.0), mon.state, mon.burns))
        doc = json.load(open(rec.last_dump_path()))
        return (rows, mon.snapshot(), mon.health(), rec.dump_count(),
                doc["reason"], doc["args"]["objective"],
                slo.all_snapshots()["slo_t"])

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[0][1][1] == "degraded" and port_side[0][3][1] == "ok"
    assert port_side[3] == 1 and port_side[4] == "slo_burn"


def test_serve_metrics_feed_the_monitor_and_degrade_health():
    """``ServeMetrics`` hooks feed an attached monitor (ITL samples
    amortized over a visit's tokens, TTFT, completions); a burning
    monitor turns the session's health ``degraded`` but leaves
    ``ready()`` True, on both sides."""
    mx.random.seed(0)
    jd = gluon.nn.Dense(2, in_units=3)
    jd.initialize()
    sessions = [JaxSession(jd, batch_buckets=(1,), name="slo_sess",
                           deterministic=False),
                InferenceSession(torch.nn.Linear(3, 2), batch_buckets=(1,),
                                 name="slo_sess", device="cpu")]
    x = np.ones((1, 3), np.float32)
    res = []
    for s, sess in zip(SIDES, sessions):
        sess.warmup(x)
        mon = s["slo"].SLOMonitor(
            "slo_sess", [s["slo"].SLO("itl_p99_ms", 5.0, window=60.0,
                                      threshold=2.0)],
            eval_interval=0.0, min_events=4).attach(sess.metrics)
        assert sess.metrics.slo is mon
        sess.metrics.observe_ttft(3.0)
        sess.metrics.observe_request(1.0, 2.0, ok=True)
        sess.metrics.observe_itl(40.0, live=2, tokens=8)   # 8 x 5 ms: good
        ok_state = (mon.state, sess.health()["state"])
        sess.metrics.observe_itl(60.0, live=2, tokens=6)   # 6 x 10 ms: bad
        h = sess.health()
        res.append((ok_state, mon.state, h["state"], h["slo"], sess.ready(),
                    [len(ev) for ev in mon._events]))
    assert res[0] == res[1]
    assert res[1][0] == ("ok", "serving")
    assert res[1][1:5] == ("degraded", "degraded",
                           {"state": "degraded", "violations": ["itl_p99_ms"],
                            "burns": 1}, True)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def test_snapshot_serve_breaker_slo_keys_match():
    """The same ServeMetrics observations, breaker and SLO monitor land
    under the same namespaced keys with the same values."""
    def script(s):
        m = s["metrics"].ServeMetrics("exp_m")
        for ms in (3.0, 9.0, 4.0):
            m.observe_request(1.0, ms, ok=True, priority="interactive")
        m.observe_request(2.0, 5.0, ok=False)
        m.observe_shed("batch")
        m.observe_ttft(12.0)
        m.observe_itl(8.0, live=3, tokens=2)
        m.set_decode_path("pallas")
        from importlib import import_module
        retry = import_module(s["export"].__name__.replace(
            "profiler.export", "resilience.retry"))
        b = retry.CircuitBreaker(1, 2, name="exp:b")
        b.record_failure()
        mon = s["slo"].SLOMonitor("exp_slo", [s["slo"].SLO(
            "goodput", 0.5, window=10.0)], eval_interval=0.0, min_events=1)
        mon.observe("completion", ok=False, ts=1.0)
        mon.evaluate(1.5)
        snap = s["export"].snapshot()
        keep = {k: v for k, v in snap.items()
                if k.startswith(("serve.exp_m.", "resilience.breaker.exp:b",
                                 "slo.exp_slo.", "recorder."))}
        del m, b, mon
        return keep

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side["serve.exp_m.requests"] == 4
    assert port_side["resilience.breaker.exp:b.state"] == "open"
    assert port_side["slo.exp_slo.goodput.burning"] == 0


def test_prometheus_rendering_matches():
    snap = {"serve.a.p99_ms": 12.5, "serve.a.decode_path": "int8",
            "resilience.retries": 3, "fleet.f.replica[0].load": 2,
            "flag": True, "nothing": None, 'q"uote': 'a"b\\c'}
    jax_side, port_side = _both(
        lambda s: (s["export"].render_prometheus(snap),
                   s["export"]._prom_name("fleet.f.replica[0].alive")))
    assert jax_side == port_side
    assert 'mxnet_serve_a_decode_path_info{value="int8"} 1' in port_side[0]


class _Probe:
    def __init__(self, name, ready, state="serving"):
        self.name = name
        self._ready = ready
        self._state = state

    def health(self):
        return {"state": self._state, "ready": self._ready}

    def ready(self):
        return self._ready


class _BadProbe(_Probe):
    def health(self):
        raise RuntimeError("probe down")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_endpoints_match(monkeypatch):
    """``start_http(0)`` on both sides: ``/healthz`` is 200 while every
    registered provider is ready and 503 (with the same JSON) once one is
    not or its probe raises; ``/metrics`` carries the serve gauges;
    ``/snapshot`` is JSON; unknown paths 404. Unregistering restores
    200."""
    for s in SIDES:
        monkeypatch.setattr(s["export"], "_server", None)
        monkeypatch.setattr(s["export"], "_server_thread", None)
    res = []
    for s in SIDES:
        exp = s["export"]
        m = s["metrics"].ServeMetrics("http_m")
        m.observe_request(1.0, 2.0)
        port = exp.start_http(0)
        assert exp.start_http(0) == port == exp.server_port()
        try:
            up, down, bad = (_Probe("a", True), _Probe("b", False),
                             _BadProbe("c", True))
            def healthz():
                code, body = _get(port, "/healthz")
                return code, json.loads(body)

            exp.register_health_provider(up)
            rows = [healthz()]
            exp.register_health_provider(down)
            rows.append(healthz())
            exp.register_health_provider(bad)
            rows.append(healthz())
            exp.unregister_health_provider(down)
            exp.unregister_health_provider(bad)
            rows.append(healthz())
            code, text = _get(port, "/metrics")
            rows.append((code, "mxnet_serve_http_m_requests 1" in text))
            code, body = _get(port, "/snapshot")
            rows.append((code, json.loads(body)["serve.http_m.requests"]))
            rows.append(_get(port, "/nope"))
        finally:
            exp.stop_http()
        assert exp.server_port() is None
        res.append(rows)
        del m
    assert res[0] == res[1]
    assert [r[0] for r in res[1]] == [200, 503, 503, 200, 200, 200, 404]
    assert res[1][2][1]["sessions"]["c"] == {"error": "probe down"}


def test_metrics_port_env_starts_the_endpoint(monkeypatch, capfd):
    """``MXNET_METRICS_PORT`` unset: no server; ``0``: an ephemeral port,
    reported on stderr — the same on both sides."""
    res = []
    for s in SIDES:
        exp = s["export"]
        monkeypatch.setattr(exp, "_server", None)
        monkeypatch.setattr(exp, "_server_thread", None)
        monkeypatch.delenv("MXNET_METRICS_PORT", raising=False)
        exp.maybe_start_from_env()
        off = exp.server_port()
        monkeypatch.setenv("MXNET_METRICS_PORT", "0")
        exp.maybe_start_from_env()
        port = exp.server_port()
        try:
            err = capfd.readouterr().err
            res.append((off, port is not None and port > 0,
                        f"MXNET_METRICS_PORT_BOUND={port}" in err,
                        _get(port, "/healthz")[0]))
        finally:
            exp.stop_http()
    assert res[0] == res[1] == (None, True, True, 200)
