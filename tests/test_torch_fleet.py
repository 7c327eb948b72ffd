"""The port's fleet layer (``serve.Replica``, ``serve.Router``,
``QueueDepthPolicy``, ``fleet_stats``) and its ``resilience.elastic.
StragglerMonitor`` against the JAX package's on the same calls.

Replicas run echo runners (each payload doubled, as ``tests/test_fleet.py``
does), so both fleets can run the same scripts under the same fault
plans: a replica death at ``replica:dispatch``, flaky dispatches that
quarantine a replica behind its fleet breaker, structural 503s at settle
time, per-request errors, hedging onto a flagged straggler's peer,
rollout through ``InferenceSession.swap``, ``scale_to`` and
``autoscale_step``. Requests are submitted one at a time, so the
outcomes — results, errors, the failover and quarantine ledger — do not
depend on thread timing, and must be equal on both sides.
"""
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon
from mxnet_tpu.resilience import elastic as jelastic
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serve import InferenceSession as JaxSession
from mxnet_tpu.serve import fleet as jfleet
from mxnet_tpu.serve import replica as jreplica
from mxnet_tpu.serve.engine import ServiceUnavailable as JaxUnavailable
from mxnet_tpu_torch.resilience import elastic as telastic
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serve import InferenceSession
from mxnet_tpu_torch.serve import fleet as tfleet
from mxnet_tpu_torch.serve import replica as treplica
from mxnet_tpu_torch.serve.engine import ServiceUnavailable

SIDES = [dict(fleet=jfleet, replica=jreplica, faults=jfaults,
              elastic=jelastic, unavailable=JaxUnavailable),
         dict(fleet=tfleet, replica=treplica, faults=tfaults,
              elastic=telastic, unavailable=ServiceUnavailable)]
WAIT = 20

# the ledger entries whose values do not depend on which replica the
# least-loaded pick chose
LEDGER = ("dispatched", "failovers", "requeued", "kills", "quarantines",
          "hedges", "hedge_wins", "fenced_results", "duplicate_submits",
          "no_candidate", "rollouts", "scaled_up", "scaled_down")


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    for s in SIDES:
        s["faults"].clear_plan()


def _echo(payloads):
    return [p * 2 for p in payloads]


def _fleet(s, n=3, runner=_echo, **kw):
    reps = [s["replica"].Replica(runner, index=i, max_batch_size=4,
                                 timeout_ms=1.0, max_queue=64)
            for i in range(n)]
    kw.setdefault("probe_ms", 0.0)
    return s["fleet"].Router(reps, **kw)


def _outcome(fut):
    try:
        return ("ok", fut.result(WAIT))
    except BaseException as e:  # noqa: BLE001 -- the outcome is the class
        return ("err", type(e).__name__,
                getattr(e, "retry_after_ms", "none") is None)


def _ledger(r):
    return {k: r.counters[k] for k in LEDGER}


def _both(fn):
    return [fn(s) for s in SIDES]


def test_dispatch_death_fails_over_exactly_once():
    """A ``die`` at replica 0's first dispatch (the first pick: every
    replica idle, replica 0 first in order): every request still gets its
    own result once, the replica is killed and routed around, and a
    duplicate submit returns the settled future."""
    def script(s):
        s["faults"].install_plan({"rules": [
            {"site": "replica:dispatch", "kind": "die", "replica": 0,
             "at": [0]}]})
        with _fleet(s, name="f_die") as r:
            outs = [_outcome(r.submit(i, key=f"k{i}")) for i in range(12)]
            dup = r.submit(99, key="k3").result(WAIT)
            return (outs, dup, _ledger(r), r.replica_count(),
                    r.health()["dead"], r.stats()["live"],
                    s["fleet"].fleet_stats()["f_die"]["dead"])

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[0] == [("ok", 2 * i) for i in range(12)]
    assert port_side[1] == 6 and port_side[2]["kills"] == 1
    assert port_side[2]["failovers"] == 1 and port_side[3] == 2


def test_flaky_dispatch_quarantines_then_probes_back():
    """Two transient dispatch failures on replica 1 trip its fleet breaker
    (a quarantine); the cooldown's picks walk it to half-open and the
    probe request heals it. No request fails."""
    def script(s):
        s["faults"].install_plan({"rules": [
            {"site": "replica:dispatch", "kind": "transient", "replica": 1,
             "times": 2}]})
        with _fleet(s, n=2, name="f_flaky", breaker_threshold=2,
                    breaker_cooldown=3) as r:
            outs = [_outcome(r.submit(i)) for i in range(10)]
            return outs, _ledger(r), r.stats()["replica"][1]["breaker"]

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[0] == [("ok", 2 * i) for i in range(10)]
    assert port_side[1]["quarantines"] == 1 and \
        port_side[1]["failovers"] == 2
    assert port_side[2] == "closed"


def test_settle_errors_structural_failover_and_user_errors():
    """A runner slot holding a structural 503 fails the request over (it
    succeeds elsewhere); a slot holding a user error is delivered as is;
    an overload-shaped 503 passes through with its hint."""
    def runner_for(s):
        def runner(payloads):
            out = []
            for p in payloads:
                name = threading.current_thread().name
                if p == 5 and "replica0" in name:
                    out.append(s["unavailable"]("replica broke"))
                elif p == 7:
                    out.append(ValueError("bad input"))
                elif p == 9:
                    e = s["unavailable"]("full")
                    e.retry_after_ms = 12.0
                    out.append(e)
                else:
                    out.append(p * 2)
            return out
        return runner

    def script(s):
        with _fleet(s, n=2, runner=runner_for(s), name="f_settle") as r:
            outs = []
            for i in (1, 5, 7, 9, 5, 2):
                fut = r.submit(i)
                outs.append(_outcome(fut))
            return outs, _ledger(r)["no_candidate"]

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    outs = port_side[0]
    assert outs[0] == ("ok", 2) and outs[1] == ("ok", 10)
    assert outs[2] == ("err", "ValueError", False)
    assert outs[3][:2] == ("err", "ServiceUnavailable") and not outs[3][2]


def test_hedge_onto_a_flagged_stragglers_peer():
    """An interactive request on a straggler-flagged replica is hedged
    after ``hedge_ms`` onto its peer, which wins; a batch-class request
    on the same straggler is never hedged. Each request goes to idle
    replicas, where the pick's tie goes to replica 0, the straggler."""
    def slow_on_zero(payloads):
        if "replica0" in threading.current_thread().name:
            time.sleep(0.5)
        return _echo(payloads)

    def one(s, name, priority):
        with _fleet(s, n=2, runner=slow_on_zero, name=name,
                    hedge_ms=20.0, straggler_ms=50.0) as r:
            r.monitor.observe(0, 1.0)             # flag replica 0
            assert r.monitor.flagged(0) and not r.monitor.flagged(1)
            out = _outcome(r.submit(3, priority=priority))
            time.sleep(0.6)                       # the loser settles
            return out, _ledger(r)

    def script(s):
        return [one(s, "f_hedge_batch", "batch"),
                one(s, "f_hedge", "interactive")]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jax_side, port_side = _both(script)
    assert jax_side == port_side
    (batch, batch_ledger), (inter, inter_ledger) = port_side
    assert batch == ("ok", 6) and inter == ("ok", 6)
    assert batch_ledger["hedges"] == 0 and batch_ledger["hedge_wins"] == 0
    assert inter_ledger["hedges"] == 1 and inter_ledger["hedge_wins"] == 1


def _dense_pair(seed, units=4):
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


def test_rollout_scale_and_autoscale_match_jax():
    """Replicas behind sessions: a rollout swaps each session warm in
    turn and the fleet then serves the new weights; ``scale_to`` grows
    through the factory and shrinks by graceful drain; a queue-depth
    policy scales an idle fleet down by one; a closed fleet refuses with
    a structural 503."""
    x = np.random.RandomState(0).randn(3).astype(np.float32)
    res = []
    for side, s in enumerate(SIDES):
        def build(idx, s=s, side=side):
            block = _dense_pair(0)[side]
            sess = (JaxSession(block, batch_buckets=(1, 4),
                               name=f"roll{idx}", deterministic=False)
                    if side == 0 else
                    InferenceSession(block, batch_buckets=(1, 4),
                                     name=f"roll{idx}", device="cpu"))
            sess.warmup(x[None])

            def runner(payloads, sess=sess):
                out = sess.predict(np.stack(payloads))
                return [np.round(np.asarray(
                    o.asnumpy() if hasattr(o, "asnumpy") else o.numpy()),
                    5).tolist() for o in out]

            return s["replica"].Replica(runner, index=idx, session=sess,
                                        max_batch_size=4, timeout_ms=1.0)

        policy = s["fleet"].QueueDepthPolicy(high=4.0, low=0.5,
                                             min_replicas=1)
        r = s["fleet"].Router([build(0), build(1)], factory=build,
                              name=f"f_roll{side}", probe_ms=0.0,
                              autoscale_policy=policy)
        try:
            rows = [r.submit(x).result(WAIT)]
            new = _dense_pair(3)[side]
            rows.append(r.rollout(new, example=x[None]))
            rows.append(r.submit(x).result(WAIT))
            rows.append([st.replica.session.assert_no_recompiles()
                         for st in r._states.values()])
            rows.append(r.scale_to(3))
            rows.append(r.scale_to(2))
            rows.append(r.autoscale_step())
            rows.append((r.ready(), r.health()["live"]))
            rows.append(_ledger(r))
        finally:
            r.close()
        with pytest.raises(Exception) as ei:
            r.submit(x)
        rows.append((type(ei.value).__name__, ei.value.retry_after_ms))
        res.append(rows)
    assert res[0] == res[1]
    assert res[1][1] == ["warm", "warm"] and res[1][0] != res[1][2]
    assert res[1][4:7] == [3, 2, 1]
    assert res[1][-1] == ("ServiceUnavailable", None)


def test_straggler_monitor_matches():
    """Scripted step times and lags give the same EWMAs, flags,
    snapshots and counter gauges; a threshold of 0 tracks and never
    flags; ``install`` publishes the monitor to the export snapshot."""
    def script(s):
        mon = s["elastic"].StragglerMonitor(threshold_ms=30.0, alpha=0.5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for times in ([0.10, 0.11, 0.10], [0.10, 0.16, 0.10],
                          [0.12, 0.20, 0.11]):
                mon.observe_step_times(times)
        mon.observe(2, 0.001, site="replica:settle")
        flags = [mon.flagged(r) for r in range(3)]
        mon.clear(1)
        quiet = s["elastic"].StragglerMonitor(threshold_ms=0.0)
        quiet.observe(0, 5.0)
        mon.install()
        export = __import__(s["fleet"].__name__.replace(
            "serve.fleet", "profiler.export"), fromlist=["snapshot"])
        snap = {k: v for k, v in export.snapshot().items()
                if k.startswith("resilience.straggler.")}
        s["elastic"].StragglerMonitor.uninstall()
        return (flags, mon.snapshot(), quiet.flagged(0), quiet.snapshot(),
                snap, s["elastic"]._active_monitor)

    jax_side, port_side = _both(script)
    assert jax_side == port_side
    assert port_side[0] == [False, True, False]
    assert port_side[4]["resilience.straggler.flags"] >= 1


def test_replica_flusher_runs_the_runner_under_inference_mode():
    """A replica given a device runs its runner on the flusher thread
    under ``torch.inference_mode()`` (a new thread inherits neither the
    device nor the mode)."""
    seen = []

    def runner(payloads):
        seen.append((torch.is_inference_mode_enabled(),
                     threading.current_thread().name))
        return _echo(payloads)

    with tfleet.Router([treplica.Replica(runner, index=0, device="cpu",
                                         timeout_ms=1.0)],
                       name="f_dev", probe_ms=0.0) as r:
        assert r.submit(4).result(WAIT) == 8
    assert seen[0][0] and "replica0" in seen[0][1]
    rep = treplica.Replica(runner, index=1, timeout_ms=1.0)
    try:
        assert rep.batcher.device is None
        assert rep.submit(2).result(WAIT) == 4
        assert not seen[-1][0]
    finally:
        rep.kill()


def test_launch_counter_is_exact_under_concurrent_replicas():
    """Replicas' flusher threads bump the decode-attention kernel's
    module-global launch count at once (eager launches and graph
    replays); under a short switch interval no update is lost."""
    import sys

    from mxnet_tpu_torch.ops.hopper import decode_attention as da

    before = da.launch_count()
    per, n = 20000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=lambda: [da.count_replays(1)
                                                for _ in range(per)])
               for _ in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(WAIT)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    assert da.launch_count() - before == per * n
