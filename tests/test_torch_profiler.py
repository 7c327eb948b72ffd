"""The port's host-side telemetry and fault injection
(``mxnet_tpu_torch.profiler``: ``core``, ``trace``, ``recorder``,
``attribution``; ``mxnet_tpu_torch.resilience``: ``faults``, ``counters``)
against the JAX package's modules on the same calls.

These are host-only copies, so the same calls must give the same traces,
spans, aggregates, flight-recorder rings, ledgers, critical-path reports
and fault-plan decisions on both sides. Time stamps, thread ids and trace
ids are left out of the comparison; everything else is compared whole.
"""
import json
import os

import pytest

from mxnet_tpu.profiler import attribution as jattr
from mxnet_tpu.profiler import core as jcore
from mxnet_tpu.profiler import recorder as jrec
from mxnet_tpu.profiler import trace as jtrace
from mxnet_tpu.resilience import counters as jcounters
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.profiler import attribution as tattr
from mxnet_tpu_torch.profiler import core as tcore
from mxnet_tpu_torch.profiler import recorder as trec
from mxnet_tpu_torch.profiler import trace as ttrace
from mxnet_tpu_torch.resilience import counters as tcounters
from mxnet_tpu_torch.resilience import faults as tfaults

SIDES = [
    dict(core=jcore, trace=jtrace, attr=jattr, rec=jrec, faults=jfaults,
         counters=jcounters),
    dict(core=tcore, trace=ttrace, attr=tattr, rec=trec, faults=tfaults,
         counters=tcounters),
]


@pytest.fixture(autouse=True)
def _clean_state():
    """Every module starts and ends stopped, empty and without a plan."""
    def clean():
        for s in SIDES:
            s["core"].stop()
            s["core"].reset()
            s["trace"].disable()
            s["trace"].reset()
            s["attr"].disable()
            s["attr"].reset()
            s["rec"].reset()
            s["counters"].reset()
            s["faults"].clear_plan()

    clean()
    yield
    clean()


def _both(fn):
    return [fn(s) for s in SIDES]


def _strip_summary(summ):
    out = dict(summ)
    for k in ("trace_id", "total_ms", "threads"):
        out.pop(k)
    out["spans"] = [{k: v for k, v in sp.items() if k != "tid"}
                    for sp in summ["spans"]]
    # spans timed by a context manager last as long as they last
    for sp in out["spans"][1:]:
        sp.pop("dur_ms")
    out["by_name"] = {k: v["calls"] for k, v in summ["by_name"].items()}
    return out


def test_traces_and_spans_match():
    def script(s):
        tr_mod = s["trace"]
        assert tr_mod.start_trace("off") is None     # disabled: no trace
        tr_mod.enable(max_traces=4)
        tr = tr_mod.start_trace("serve.request[x]", args={"priority": "i"})
        tr.span_at("serve::admit", 1_000, 3_000, {"priority": "i"})
        fid = tr.flow_out("serve::enqueue")
        tr.flow_in(fid, "serve::enqueue")
        with tr.span("serve::queue", {"n": 1}):
            pass
        with tr_mod.activate(tr):
            assert tr_mod.current() is tr
            with tr_mod.span("serve::session_run(s)"):
                pass
        assert tr_mod.current() is None
        try:
            with tr.span("serve::execute"):
                raise ValueError("x")
        except ValueError:
            pass
        tr.finish(error="boom")
        tr.span_at("after_finish", 0, 1)            # ignored once sealed
        for i in range(6):                          # registry is bounded
            tr_mod.start_trace(f"t{i}")
        summ = tr_mod.summary(tr.trace_id)
        names = [x["name"] for x in tr_mod.summaries(limit=10)]
        by_name = {k: v["calls"] for k, v in tr.summary()["by_name"].items()}
        return _strip_summary(tr.summary()), summ, names, by_name

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    summ, evicted, names, by_name = port_side
    assert evicted is None and names == ["t2", "t3", "t4", "t5"]
    assert summ["finished"] and summ["error"] == "boom"
    assert [sp["name"] for sp in summ["spans"]] == [
        "serve::admit", "serve::queue", "serve::session_run(s)",
        "serve::execute"]
    assert summ["spans"][0]["dur_ms"] == 0.002
    assert summ["spans"][3]["args"] == {"error": "ValueError"}
    assert by_name == {"serve::admit": 1, "serve::queue": 1,
                       "serve::session_run(s)": 1, "serve::execute": 1}


def _events(core):
    return [{k: v for k, v in ev.items() if k not in ("ts", "pid", "tid",
                                                      "dur", "id")}
            for ev in core.snapshot_events()]


def test_event_bus_aggregates_counters_and_dump(tmp_path):
    def script(s):
        core, tr_mod = s["core"], s["trace"]
        core.record_duration("off", "host", 0, 1_000_000)   # aggregate only
        core.start()
        core.register_thread_name("worker-x", tid=12345)
        core.record_duration("serve::request(a)", "serve", 0, 2_000_000,
                             args={"ok": True})
        core.record_instant("serve::batch(a)", "serve", args={"size": 2})
        core.set_counter("serve.queue_depth(a)", 3, cat="serve")
        core.incr_counter("resilience.x", 2)
        core.incr_counter("resilience.x")
        tr_mod.enable()
        tr = tr_mod.start_trace("req")
        tr.span_at("serve::queue", 0, 10_000, {"k": 1})
        tr.flow_in(tr.flow_out("h"), "h")
        path = core.dump(str(tmp_path / f"{id(core)}.json"))
        with open(path) as f:
            doc = json.load(f)
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"
                and e.get("tid") == 12345]
        agg = core.aggregate_stats()
        table = core.dumps_table(reset_after=True).splitlines()[0]
        return (_events(core), agg, core.counters_snapshot(),
                core.get_counter("resilience.x"), meta[0]["args"], table,
                core.aggregate_stats())

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    events, agg, counters = port_side[:3]
    assert [e["ph"] for e in events] == ["X", "i", "C", "C", "C", "b", "e",
                                         "s", "f"]
    assert agg["off"]["calls"] == 1 and agg["serve::request(a)"]["total_s"] \
        == 0.002
    assert counters == {"serve.queue_depth(a)": 3, "resilience.x": 3}
    assert port_side[4] == {"name": "worker-x"} and port_side[6] == {}


def test_flight_recorder_ring_and_dump(tmp_path, monkeypatch):
    """The ring, the resilience counters and ``dump()``: the dump file's
    document (ring, counters, reason, args), the per-reason rate limit,
    the ``MXNET_FLIGHT_RECORDER_MAX_DUMPS`` cap and the dump accounting."""
    def strip(ring):
        return [{k: v for k, v in e.items() if k not in ("t", "thread")}
                for e in ring]

    def script(s):
        rec, counters = s["rec"], s["counters"]
        side = "jax" if s is SIDES[0] else "port"
        monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR",
                           str(tmp_path / side))
        monkeypatch.setenv("MXNET_FLIGHT_RECORDER_MAX_DUMPS", "2")
        rec.disable()
        rec.note("fault", "ignored")
        assert rec.dump("off") is None              # disabled: no file
        rec.enable()
        rec.note("shed", "serve.shed(a)", {"priority": "batch"})
        counters.incr("resilience.faults_injected")
        ring = strip(rec.snapshot())
        first = rec.dump("breaker_open", args={"breaker": "serve:a"})
        limited = rec.dump("breaker_open")          # same reason, < 1 s
        second = rec.dump("watchdog_timeout")
        capped = rec.dump("slo_burn")               # over the cap
        with open(first) as f:
            doc = json.load(f)
        explicit = rec.dump("manual", path=str(tmp_path / side / "x.json"),
                            force=True)
        return (ring, counters.snapshot(), counters.should_warn(10),
                counters.should_warn(11), limited, capped,
                doc["reason"], doc["args"], strip(doc["ring"]),
                doc["resilience_counters"],
                os.path.basename(first).split("-", 2)[2],
                os.path.basename(second).split("-", 2)[2],
                os.path.basename(explicit), rec.dump_count(),
                os.path.basename(rec.last_dump_path()),
                [e["kind"] for e in strip(rec.snapshot())])

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    ring = port_side[0]
    assert [e["kind"] for e in ring] == ["shed", "counter"]
    assert ring[1]["args"] == {"value": 1} and ring[1]["seq"] == 2
    assert port_side[4] is None and port_side[5] is None
    assert port_side[6] == "breaker_open"
    assert port_side[10:13] == ("breaker_open.json", "watchdog_timeout.json",
                                "x.json")
    assert port_side[13] == 3


def test_ledger_and_report_match():
    steps = [(0.5, 0.2, 17.0, 0.0, 4, None), (0.4, 0.1, 140.0, 0.3, 4, 32),
             (0.6, 0.3, 18.0, 0.0, 2, 2), (0.2, 0.1, 70.0, 0.0, 3, 24)]

    def script(s):
        attr, tr_mod = s["attr"], s["trace"]
        led = attr.Ledger("t_ledger", window=3)
        for row in steps:
            led.observe_step(*row[:4], live=row[4], tokens=row[5])
            led.observe_schedule(row[0] / 2)
        tr_mod.enable()
        tr = tr_mod.start_trace("serve.request[e]")
        t = 0
        for name, dur, args in (
                ("serve::queue", 2_000_000, None),
                ("serve::prefill_chunk", 5_000_000, {"slot": 0, "n": 16}),
                ("serve::decode_step", 9_000_000,
                 {"host_ms": 0.5, "dispatch_ms": 0.1, "device_ms": 8.0,
                  "wait_ms": 0.0, "tokens": 8}),
                ("serve::decode_step", 3_000_000,
                 {"host_ms": 0.4, "dispatch_ms": 0.2, "device_ms": 2.0,
                  "wait_ms": 0.1}),
                ("serve::execute", 1_000_000, {"ok": True}),
                ("misc", 1_000_000, None)):
            tr.span_at(name, t, t + dur, args)
            t += dur
        tr.finish()
        rep = attr.report(tr.trace_id)
        rep = {k: v for k, v in rep.items()
               if k not in ("trace_id", "total_ms", "coverage")}
        attr.enable()
        with attr.phase_scope("decode"):
            phase = attr.current_phase()
            attr.note_wait(2_000_000)
        attr.note_wait(1_000_000, phase="prefill")
        return (led.snapshot(), led.host_overhead_fraction(),
                led.device_ms_per_token(), rep, phase,
                attr.current_phase(), attr.wait_ms_by_phase(),
                attr.thread_wait_ns(), attr.report(10 ** 9))

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    snap, _, per_tok, rep = port_side[:4]
    assert snap["steps"] == 4 and snap["window"] == 3
    assert snap["tokens"] == 32 + 2 + 24 and per_tok == 228.0 / 58
    assert rep["ledger_steps"] == 2 and rep["ledger_tokens"] == 9
    assert rep["prefill_chunks"] == 1 and rep["settle_ms"] == 1.0
    assert port_side[6] == {"decode": 2.0, "prefill": 1.0}


def test_attribution_wait_feed_is_off_until_enabled():
    """``thread_wait_ns`` stays 0 while disabled (nothing in the port
    feeds it); the ledger window reads its flag."""
    tattr.note_wait(5_000)
    assert tattr.thread_wait_ns() == 0 and tattr.wait_ms_by_phase() == {}
    assert not hasattr(tattr, "device_cross_check")


PLAN = {"seed": 11, "rules": [
    {"site": "serve:decode", "kind": "transient", "at": [1, 3]},
    {"site": "serve:execute", "kind": "fatal", "times": 2},
    {"site": "serve:queue", "kind": "delay", "seconds": 0.0, "prob": 0.4},
    {"site": "serve:queue", "kind": "die", "at": [17]},
    {"site": "trainer:grad", "kind": "nan", "at": [0]},
    {"site": "ckpt:write", "kind": "torn", "at": [1]},
    {"site": "preempt:deliver", "kind": "preempt", "times": 1},
    {"site": "trainer:replica_step", "kind": "replica_delay",
     "seconds": 0.0, "replica": 1, "times": 5},
    {"site": "trainer:param", "kind": "param_corrupt", "replica": 2,
     "at": [0]},
    {"site": "kvstore:allreduce", "kind": "chip_loss",
     "device": {"axis": "dp", "index": 1}, "at": [0]},
    {"site": "*", "kind": "transient", "prob": 0.05},
]}
CALLS = ([("serve:decode", None)] * 5 + [("serve:execute", None)] * 4
         + [("serve:queue", {"priority": "batch"})] * 20
         + [("trainer:grad", None), ("ckpt:write", None),
            ("ckpt:write", None), ("preempt:deliver", None),
            ("preempt:deliver", None)]
         + [("trainer:replica_step", {"replica": r}) for r in (0, 1, 1, 2)]
         + [("trainer:param", {"replica": 2}), ("kvstore:allreduce", None)])


def _run_plan(faults):
    out = []
    for site, info in CALLS:
        try:
            out.append(("ret", faults.fault_point(site, info)))
        except BaseException as e:  # noqa: BLE001 -- die is a BaseException
            extra = (getattr(e, "replica", None), getattr(e, "device", None))
            out.append((type(e).__name__, str(e), extra))
    return out


def test_fault_plan_decisions_match():
    def script(s):
        faults = s["faults"]
        plan = faults.install_plan(PLAN)
        out = _run_plan(faults)
        stats = plan.stats()
        fired = plan.fired_total()
        n = s["counters"].get("resilience.faults_injected")
        faults.clear_plan()
        return out, stats, fired, n, faults.fault_point("serve:decode")

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    out, stats, fired, n = port_side[:4]
    assert [o[0] for o in out[:5]] == ["ret", "TransientFaultError", "ret",
                                       "TransientFaultError", "ret"]
    assert out[29] == ("ret", "nan") and fired == n
    assert out[-1][0] == "ChipLostError"
    assert out[-1][2] == (0, {"axis": "dp", "index": 1})
    assert stats[0] == {"site": "serve:decode", "kind": "transient",
                        "hits": 5, "fired": 2}


@pytest.mark.parametrize("bad,match", [
    ({"rules": [{"kind": "fatal", "at": [0]}]}, "missing 'site'"),
    ({"rules": [{"site": "a", "kind": "boom", "at": [0]}]}, "unknown kind"),
    ({"rules": [{"site": "a", "times": 1, "at": [0]}]}, "exactly one"),
    ({"rules": [{"site": "a", "kind": "fatal", "device": 1, "at": [0]}]},
     "only valid on chip_loss"),
    ({"rules": [{"site": "a", "kind": "chip_loss", "device": {"axis": 1},
                 "at": [0]}]}, "coordinate device"),
    ({"nope": []}, "'rules' list"),
    ("{not json", "not valid JSON"),
])
def test_bad_plans_raise_on_both(bad, match):
    for s in SIDES:
        with pytest.raises(Exception, match=match):
            s["faults"].install_plan(bad)
    with pytest.raises(MXNetError):
        tfaults.install_plan(bad)


@pytest.mark.parametrize("form", ["json", "file"])
def test_env_plan_installs_lazily(monkeypatch, tmp_path, form):
    spec = {"rules": [{"site": "serve:queue", "kind": "fatal", "at": [1]}]}
    raw = json.dumps(spec)
    if form == "file":
        path = tmp_path / "plan.json"
        path.write_text(raw)
        raw = f"@{path}"
    monkeypatch.setenv("MXNET_FAULT_PLAN", raw)

    def script(s):
        faults = s["faults"]
        faults._active = None
        faults._env_checked = False
        out = [faults.fault_point("serve:queue")]
        try:
            faults.fault_point("serve:queue")
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
        out.append(faults.get_plan().stats())
        faults.clear_plan()                 # also stops env re-install
        out.append(faults.get_plan())
        return out

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[1] == "InjectedFaultError" and port_side[3] is None
