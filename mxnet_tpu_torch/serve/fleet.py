"""Fleet-grade serving: a health-aware `Router` over N in-process
:class:`~.replica.Replica` instances (the port's counterpart of
``mxnet_tpu/serve/fleet.py``, host-only).

The single-replica stack (session + batcher + generator) is hard to
kill; this module makes a *fleet* of them hard to kill. One
:class:`Router` owns the request path in front of the replicas and
provides, in order of how often each saves you:

* **health-aware least-loaded dispatch** — every submit picks the ready
  replica with the smallest ``(load, p99_ms)`` key, where *ready* folds
  in the replica's liveness probe (flusher thread alive), admission
  state, session warmth, and the session's own circuit breaker. A
  replica the fleet should route around never sees the request.
* **failover with exactly-once settlement** — every request carries an
  idempotency key and a *generation* per dispatch attempt. When a
  replica dies (a ``die`` at the ``replica:dispatch`` site, a flusher
  killed mid-batch, a drain that never completes), the Router fences
  that replica's generations *first*, then requeues its undelivered
  in-flight requests to survivors — so the dead replica's late/dying
  503s settle into dropped duplicates, never client-visible errors,
  and a request is delivered exactly once no matter how many replicas
  it transited. Failed-over work is bounded by
  ``MXNET_FLEET_MAX_FAILOVERS``; each replica sits behind a fleet-level
  :class:`~..resilience.retry.CircuitBreaker` whose half-open state
  re-probes the replica with one real request.
* **hedged retries** — an *interactive* request dispatched to a
  straggler-flagged replica (per-replica latency-lag EWMAs in a
  :class:`~..resilience.elastic.StragglerMonitor`) is hedged to the
  next-best replica after ``MXNET_FLEET_HEDGE_MS``; the first settle
  wins, the loser is cancelled and counted. The batch class is never
  hedged (hedging doubles work — only latency-sensitive traffic earns
  it), and a request is never hedged twice.
* **zero-downtime rollout** — :meth:`Router.rollout` walks the live
  replicas one at a time: stop dispatching to one, let its in-flight
  work settle, hot-swap its session (warm swap = parameter transplant
  into the live tensors — no new signature), resume. The rest of the
  fleet keeps serving; zero requests dropped.
* **autoscaling hooks** — :meth:`Router.scale_to` adds replicas through
  the ``factory`` or removes them by graceful drain (drain timeout =
  the failover path, never dropped work); :meth:`Router.autoscale_step`
  runs a pluggable policy over ``profiler.export.snapshot()`` gauges
  (queue depth / goodput / p99) — :class:`QueueDepthPolicy` is the
  default shape.

The Router registers itself as the fleet's *single* health provider on
the unified export surface (``/healthz``): a dead-and-routed-around
replica is an event in the fleet gauges, not a process-level 503.
``fleet_stats()`` feeds ``profiler.export.snapshot()`` with the
``fleet.<name>.*`` gauge namespace.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref
from concurrent.futures import CancelledError, Future

from ..profiler import core as _prof
from ..profiler import export as _export
from ..resilience.elastic import StragglerMonitor
from ..resilience.faults import SimulatedWorkerDeath
from ..resilience.retry import CircuitBreaker
from .engine import DeadlineExceeded, ServeError, ServiceUnavailable
from .replica import Replica

__all__ = ["Router", "QueueDepthPolicy", "fleet_stats"]

# live routers, for the unified export surface (weak: a retired fleet
# drops out of the gauge namespace on its own)
_routers: "weakref.WeakSet" = weakref.WeakSet()

#: closed outcome ledger the Router keeps (all monotonic counters)
_COUNTERS = (
    "dispatched", "failovers", "requeued", "kills", "quarantines",
    "hedges", "hedge_wins", "hedge_losses", "fenced_results",
    "duplicate_settles", "duplicate_submits", "no_candidate",
    "rollouts", "scaled_up", "scaled_down",
)


def fleet_stats():
    """``{router_name: stats()}`` over every live Router (the gauge
    surface behind ``profiler.export.snapshot()``'s ``fleet.*``
    namespace)."""
    return {r.name: r.stats() for r in list(_routers)}


class _FleetRequest:
    """Router-side bookkeeping for one client request across dispatch
    attempts. ``valid_gens`` is the fencing set: a settle arriving with
    a generation not in it (a dead replica's dying 503, a cancelled
    hedge loser's late result) is dropped, never delivered."""

    __slots__ = ("key", "payload", "priority", "deadline", "future",
                 "valid_gens", "next_gen", "settled", "hedged",
                 "hedge_gen", "hedge_timer", "failovers", "t_submit",
                 "attempts")

    def __init__(self, key, payload, priority, deadline):
        self.key = key
        self.payload = payload
        self.priority = priority
        self.deadline = deadline          # absolute monotonic or None
        self.future = Future()            # the client's future
        self.valid_gens = set()
        self.next_gen = 0
        self.settled = False
        self.hedged = False
        self.hedge_gen = None
        self.hedge_timer = None
        self.failovers = 0
        self.t_submit = time.monotonic()
        self.attempts = []                # [(replica_idx, gen, fut)]


class _ReplicaState:
    """Router-side view of one replica: the fleet-level breaker that
    quarantines it, the admission flag rollout/scale toggle, and the
    outstanding map (key -> (request, generation)) that failover fences
    and requeues."""

    __slots__ = ("index", "replica", "breaker", "accepting", "dead",
                 "quarantined", "outstanding")

    def __init__(self, index, replica, breaker):
        self.index = index
        self.replica = replica
        self.breaker = breaker
        self.accepting = True
        self.dead = False
        self.quarantined = False
        self.outstanding = {}


class QueueDepthPolicy:
    """Default autoscaling policy: per-replica queue depth bands.

    Scale up one replica when mean queued+in-flight per live replica
    exceeds ``high``; scale down one when it falls below ``low`` (never
    past ``min_replicas``/``max_replicas``). The policy receives the
    full ``export.snapshot()`` dict too, so a custom policy can key off
    goodput or interactive p99 instead — the Router only requires
    ``policy(snapshot, router) -> target_replica_count``."""

    def __init__(self, high=4.0, low=0.5, min_replicas=1, max_replicas=8):
        self.high = float(high)
        self.low = float(low)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)

    def __call__(self, snapshot, router):
        n = router.replica_count()
        if n == 0:
            return self.min_replicas
        per = router.total_load() / n
        if per > self.high and n < self.max_replicas:
            return n + 1
        if per < self.low and n > self.min_replicas:
            return n - 1
        return n


class Router:
    """Health-aware fleet router with exactly-once failover settlement.

    Parameters
    ----------
    replicas : iterable of Replica
        Initial fleet. Replica-owned sessions are adopted: they leave
        the process-level ``/healthz`` roll (the Router answers for the
        fleet) but keep their own breakers/watchdogs.
    factory : callable(index) -> Replica, optional
        Builds a new replica for :meth:`scale_to` / autoscaling.
    hedge_ms, straggler_ms, probe_ms, max_failovers,
    breaker_threshold, breaker_cooldown :
        Overrides of the matching ``MXNET_FLEET_*`` flags.
    autoscale_policy : callable(snapshot, router) -> int, optional
        Target-size policy for :meth:`autoscale_step`
        (:class:`QueueDepthPolicy` shape).
    """

    def __init__(self, replicas=(), factory=None, name="fleet",
                 hedge_ms=None, straggler_ms=None, probe_ms=None,
                 max_failovers=None, breaker_threshold=None,
                 breaker_cooldown=None, autoscale_policy=None):
        from .. import config

        def _flag(v, flag):
            return v if v is not None else config.get(flag)

        self.name = name
        self.factory = factory
        self.hedge_ms = float(_flag(hedge_ms, "MXNET_FLEET_HEDGE_MS"))
        self.probe_ms = float(_flag(probe_ms, "MXNET_FLEET_PROBE_MS"))
        self.max_failovers = int(
            _flag(max_failovers, "MXNET_FLEET_MAX_FAILOVERS"))
        self._breaker_threshold = int(
            _flag(breaker_threshold, "MXNET_FLEET_BREAKER_THRESHOLD"))
        self._breaker_cooldown = int(
            _flag(breaker_cooldown, "MXNET_FLEET_BREAKER_COOLDOWN"))
        self.monitor = StragglerMonitor(
            threshold_ms=_flag(straggler_ms, "MXNET_FLEET_STRAGGLER_MS"))
        self.autoscale_policy = autoscale_policy
        self._lock = threading.RLock()
        self._states = {}                 # index -> _ReplicaState
        self._next_idx = 0
        self._requests = {}               # key -> live _FleetRequest
        self._settled = collections.OrderedDict()  # key -> settled Future
        self._settled_cap = 4096
        self._seq = 0
        self._recent_lat = collections.deque(maxlen=256)
        self.counters = dict.fromkeys(_COUNTERS, 0)
        self._closed = False
        self._draining = False
        for r in replicas:
            self.add_replica(r)
        self._supervisor = None
        if self.probe_ms > 0:
            self._supervisor = threading.Thread(
                target=self._supervise, daemon=True,
                name=f"mxtpu-fleet-supervisor[{name}]")
            self._supervisor.start()
        _export.register_health_provider(self)
        _routers.add(self)

    # -- fleet membership ---------------------------------------------------
    def add_replica(self, replica):
        """Adopt ``replica`` into the fleet (assigns a fleet-unique
        index when the replica's collides). Returns its index."""
        with self._lock:
            idx = int(getattr(replica, "index", self._next_idx))
            if idx in self._states:
                idx = self._next_idx
            replica.index = idx
            self._next_idx = max(self._next_idx, idx + 1)
            breaker = CircuitBreaker(
                failure_threshold=self._breaker_threshold,
                cooldown_calls=self._breaker_cooldown,
                name=f"fleet:{self.name}:r{idx}")
            self._states[idx] = _ReplicaState(idx, replica, breaker)
        if replica.session is not None:
            # the Router answers /healthz for the whole fleet; a dead
            # (and routed-around) replica must not wedge the process
            # probe at 503
            _export.unregister_health_provider(replica.session)
        return idx

    def replica_count(self):
        with self._lock:
            return sum(1 for st in self._states.values() if not st.dead)

    def total_load(self):
        with self._lock:
            states = [st for st in self._states.values() if not st.dead]
        return sum(st.replica.load() for st in states)

    # -- submit / dispatch --------------------------------------------------
    def submit(self, payload, priority="interactive", deadline_ms=None,
               key=None):
        """Admit one request into the fleet; returns the client future.

        ``key`` is the request's idempotency key (one is generated when
        omitted): a duplicate submit — same key, whether the original is
        in flight or already settled — returns the original future and
        never dispatches a second copy. ``deadline_ms`` is the total
        fleet-side budget; failover re-dispatches carry the *remaining*
        budget, not a fresh one."""
        if self._closed or self._draining:
            raise ServiceUnavailable(
                f"fleet {self.name!r} is "
                f"{'closed' if self._closed else 'draining'}")
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None and deadline_ms > 0
                    else None)
        with self._lock:
            if key is not None:
                live = self._requests.get(key)
                if live is not None:
                    self.counters["duplicate_submits"] += 1
                    return live.future
                done = self._settled.get(key)
                if done is not None:
                    self.counters["duplicate_submits"] += 1
                    return done
            else:
                self._seq += 1
                key = f"~{self.name}:{self._seq}"
            req = _FleetRequest(key, payload, priority, deadline)
            self._requests[key] = req
        self._dispatch(req)
        return req.future

    def _pick_locked(self, exclude):
        """Least-loaded ready replica by ``(load, p99_ms)``; caller
        holds the lock. Non-closed fleet breakers get an ``allow()``
        query each pick — that's what walks an open breaker's call-count
        cooldown toward half-open; a granted half-open probe slot means
        THIS request is the re-probe and the quarantined replica is
        chosen over the healthy ones (probes are one per cooldown
        window, and the failover budget protects the request)."""
        best = None
        best_key = None
        for st in self._states.values():
            if st.index in exclude or st.dead or not st.accepting:
                continue
            rep = st.replica
            if not rep.alive():
                continue
            if str(st.breaker.state) != "closed":
                if st.breaker.allow():
                    return st            # the half-open re-probe
                continue
            if not rep.ready():
                continue
            k = (rep.load(), rep.p99_ms())
            if best_key is None or k < best_key:
                best, best_key = st, k
        return best

    def _dispatch(self, req, exclude=None, hedge=False):
        """Dispatch (or re-dispatch) ``req`` onto the best replica,
        absorbing synchronous dispatch failures: a replica death fails
        over to a survivor, overload rotates to the next-best replica
        (passing the last ``retry_after_ms``-bearing 503 through when
        the whole fleet is saturated), structural failures count against
        the replica's fleet breaker. A hedge dispatch (``hedge=True``)
        gives up silently on any failure — the primary attempt is still
        in flight and must win rather than inherit a hedge-path error."""
        exclude = set(exclude or ())
        overload = None
        while True:
            now = time.monotonic()
            if req.deadline is not None and now >= req.deadline:
                if not hedge:
                    self._finish(req, error=DeadlineExceeded(
                        f"fleet {self.name!r}: deadline expired after "
                        f"{req.failovers} failover(s)"))
                return
            settle = None
            with self._lock:
                if req.settled:
                    return
                st = None if self._closed else self._pick_locked(exclude)
                if st is None:
                    if hedge:
                        return
                    self.counters["no_candidate"] += 1
                    err = overload or ServiceUnavailable(
                        f"fleet {self.name!r}: no ready replica "
                        f"(tried {len(exclude)} of "
                        f"{len(self._states)}; fleet "
                        f"{'closed' if self._closed else 'degraded'})")
                    settle = self._finish_locked(req, error=err)
                else:
                    gen = req.next_gen
                    req.next_gen += 1
                    req.valid_gens.add(gen)
                    if hedge:
                        req.hedge_gen = gen
                    st.outstanding[req.key] = (req, gen)
            if st is None:
                if settle is not None:
                    settle()
                return
            remaining_ms = None
            if req.deadline is not None:
                remaining_ms = max(0.1, (req.deadline - now) * 1e3)
            try:
                fut = st.replica.submit(req.payload, priority=req.priority,
                                        deadline_ms=remaining_ms,
                                        key=req.key)
            except SimulatedWorkerDeath:
                # replica death AT dispatch: fence + requeue its other
                # outstanding work, then fail this request over
                with self._lock:
                    st.outstanding.pop(req.key, None)
                    req.valid_gens.discard(gen)
                self._mark_dead(st, reason="dispatch_die")
                if hedge:
                    return
                if not self._count_failover(req):
                    return
                exclude.add(st.index)
                continue
            except DeadlineExceeded as exc:
                with self._lock:
                    st.outstanding.pop(req.key, None)
                    req.valid_gens.discard(gen)
                if not hedge:
                    self._finish(req, error=exc)
                return
            except Exception as exc:  # pylint: disable=broad-except
                with self._lock:
                    st.outstanding.pop(req.key, None)
                    req.valid_gens.discard(gen)
                if getattr(exc, "retry_after_ms", None) is not None:
                    # overload-shaped 503: healthy-but-full replica. No
                    # breaker penalty; rotate to the next-best replica,
                    # and if the WHOLE fleet is saturated hand the
                    # backpressure hint to the client
                    overload = exc
                    exclude.add(st.index)
                    if hedge:
                        return
                    continue
                # structural dispatch failure (flaky dispatch RPC, shut
                # batcher): penalize the fleet breaker and fail over
                self._record_failure(st)
                if hedge:
                    return
                if not self._count_failover(req):
                    return
                exclude.add(st.index)
                continue
            with self._lock:
                req.attempts.append((st.index, gen, fut))
                self.counters["dispatched"] += 1
            fut.add_done_callback(
                lambda f, s=st, g=gen, r=req: self._on_settle(r, s, g, f))
            if not hedge:
                self._maybe_arm_hedge(req, st)
            return

    def _count_failover(self, req):
        """Charge one failover against ``req``; False (and a terminal
        503) once the budget is exhausted."""
        with self._lock:
            req.failovers += 1
            self.counters["failovers"] += 1
            over = req.failovers > self.max_failovers
        if over:
            self._finish(req, error=ServiceUnavailable(
                f"fleet {self.name!r}: request exhausted its failover "
                f"budget (MXNET_FLEET_MAX_FAILOVERS="
                f"{self.max_failovers})"))
            return False
        return True

    def _record_failure(self, st):
        with self._lock:
            was_open = str(st.breaker.state) == "open"
            st.breaker.record_failure()
            if not was_open and str(st.breaker.state) == "open":
                self.counters["quarantines"] += 1

    # -- settlement ---------------------------------------------------------
    def _on_settle(self, req, st, gen, fut):
        """Done-callback for one dispatch attempt's batcher future —
        the exactly-once gate. Runs on the settling replica's flusher
        thread (or the canceller's)."""
        try:
            result, error = fut.result(timeout=0), None
        except CancelledError:
            # the hedge loser we cancelled ourselves; already counted
            with self._lock:
                entry = st.outstanding.get(req.key)
                if entry is not None and entry[1] == gen:
                    st.outstanding.pop(req.key, None)
            return
        except BaseException as exc:  # noqa: BLE001 -- per-request error
            result, error = None, exc
        failover = False
        record_fail = False
        settle = None
        with self._lock:
            entry = st.outstanding.get(req.key)
            if entry is not None and entry[1] == gen:
                st.outstanding.pop(req.key, None)
            if req.settled:
                self.counters["duplicate_settles"] += 1
                return
            if gen not in req.valid_gens:
                # fenced: a dead/quarantined replica's dying settle
                self.counters["fenced_results"] += 1
                return
            if error is None:
                st.breaker.record_success()
                self._observe_latency_locked(st, req)
                if req.hedged:
                    if gen == req.hedge_gen:
                        self.counters["hedge_wins"] += 1
                    else:
                        self.counters["hedge_losses"] += 1
                settle = self._finish_locked(req, result=result,
                                             winner_gen=gen)
            elif isinstance(error, DeadlineExceeded):
                # the request's own budget, not the replica's health
                settle = self._finish_locked(req, error=error,
                                             winner_gen=gen)
            elif isinstance(error, ServeError) \
                    and getattr(error, "retry_after_ms", None) is not None:
                # overload-shaped: pass the backpressure through
                settle = self._finish_locked(req, error=error,
                                             winner_gen=gen)
            elif isinstance(error, ServiceUnavailable):
                # structural 503 at settle time (session breaker open,
                # batcher shut under us): quarantine-worthy — fail over
                req.valid_gens.discard(gen)
                failover = True
            else:
                # a per-request model/user error: deliver it (retrying a
                # deterministic failure elsewhere just re-fails slower),
                # but count it against the replica's breaker so a
                # replica failing EVERY request still quarantines
                settle = self._finish_locked(req, error=error,
                                             winner_gen=gen)
                record_fail = True
        if settle is not None:
            # client future settles OUTSIDE the Router lock: done-
            # callbacks run on this thread and may re-enter the Router
            settle()
        if failover:
            self._record_failure(st)
            if self._count_failover(req):
                self._dispatch(req, exclude={st.index})
        elif record_fail:
            self._record_failure(st)

    def _observe_latency_locked(self, st, req):
        """Feed the straggler monitor: this attempt's fleet-relative
        latency lag (latency minus the recent fleet median)."""
        lat = time.monotonic() - req.t_submit
        self._recent_lat.append(lat)
        srt = sorted(self._recent_lat)
        median = srt[len(srt) // 2]
        self.monitor.observe(st.index, max(0.0, lat - median),
                             site="replica:settle")

    def _finish_locked(self, req, result=None, error=None,
                       winner_gen=None):
        """Bookkeeping half of exactly-once settlement (caller holds
        the lock): flip ``req.settled``, cancel the hedge timer, fence
        and unregister the losing attempts. Returns a zero-arg action
        that settles the CLIENT future and cancels the losers — the
        caller MUST run it after releasing the lock (``set_result``
        fires done-callbacks on this thread, and running arbitrary
        client callbacks / loser cancellation under the Router lock is
        a lock-order hazard the mxlint L002 gate flags). Returns None
        on a duplicate settle."""
        if req.settled:
            self.counters["duplicate_settles"] += 1
            return None
        req.settled = True
        if req.hedge_timer is not None:
            req.hedge_timer.cancel()
            req.hedge_timer = None
        losers = [(i, g, f) for (i, g, f) in req.attempts
                  if g != winner_gen and f is not None]
        req.valid_gens.clear()
        for i, _g, _f in losers:
            other = self._states.get(i)
            if other is not None:
                entry = other.outstanding.get(req.key)
                if entry is not None and entry[0] is req:
                    other.outstanding.pop(req.key, None)
        self._requests.pop(req.key, None)
        self._settled[req.key] = req.future
        while len(self._settled) > self._settled_cap:
            self._settled.popitem(last=False)

        def settle():
            # batcher futures are never RUNNING, so cancel() wins
            # unless the attempt already settled (in which case its
            # _on_settle is fenced/duplicate-dropped)
            if error is not None:
                req.future.set_exception(error)
            else:
                req.future.set_result(result)
            for _i, _g, f in losers:
                f.cancel()

        return settle

    def _finish(self, req, result=None, error=None, winner_gen=None):
        with self._lock:
            settle = self._finish_locked(req, result=result, error=error,
                                         winner_gen=winner_gen)
        if settle is not None:
            settle()

    # -- hedging ------------------------------------------------------------
    def _maybe_arm_hedge(self, req, st):
        """Arm a hedge timer iff: hedging on, interactive class, first
        hedge for this request, the chosen replica is straggler-flagged,
        and a second replica exists to hedge onto."""
        if self.hedge_ms <= 0 or req.priority != "interactive":
            return
        with self._lock:
            if req.settled or req.hedged or req.hedge_timer is not None:
                return
            if not self.monitor.flagged(st.index):
                return
            if not any(o.index != st.index and not o.dead and o.accepting
                       and o.replica.alive()
                       for o in self._states.values()):
                return
            t = threading.Timer(self.hedge_ms / 1e3, self._fire_hedge,
                                args=(req, st.index))
            t.daemon = True
            req.hedge_timer = t
        t.start()

    def _fire_hedge(self, req, primary_idx):
        with self._lock:
            if req.settled or req.hedged or self._closed:
                return
            req.hedged = True            # never hedge twice
            req.hedge_timer = None
            self.counters["hedges"] += 1
        self._dispatch(req, exclude={primary_idx}, hedge=True)

    # -- failure detection / failover ---------------------------------------
    def _mark_dead(self, st, reason="dead"):
        """Replica death: fence its generations FIRST (any settle still
        in flight from it is dropped as fenced), requeue its undelivered
        outstanding requests to survivors with their remaining deadline
        budget, then hard-kill the replica (whose dying 503s are now
        harmless). Idempotent."""
        with self._lock:
            if st.dead:
                return
            st.dead = True
            st.accepting = False
            self.counters["kills"] += 1
            requeue = []
            for _key, (req, gen) in list(st.outstanding.items()):
                req.valid_gens.discard(gen)
                if req.settled:
                    continue
                # a hedge/failover twin may still be live elsewhere; the
                # request is only requeued when NO valid attempt remains
                if req.valid_gens:
                    continue
                requeue.append(req)
            st.outstanding.clear()
            self.monitor.clear(st.index)
        for req in requeue:
            with self._lock:
                self.counters["requeued"] += 1
            if self._count_failover(req):
                self._dispatch(req, exclude={st.index})
        try:
            st.replica.kill()
        except Exception:  # noqa: BLE001 -- death cleanup is best-effort
            pass

    def kill_replica(self, index, reason="manual"):
        """Hard-kill replica ``index`` (the chaos harness's mid-traffic
        kill switch); its in-flight work fails over. True if it was
        alive."""
        with self._lock:
            st = self._states.get(int(index))
            if st is None or st.dead:
                return False
        self._mark_dead(st, reason=reason)
        return True

    def _supervise(self):
        """Background probe loop (``MXNET_FLEET_PROBE_MS``): detects
        replicas whose flusher died mid-batch (an execution-site ``die``
        kills the thread without any dispatch-time signal) and walks
        quarantined sessions' breaker cooldowns so an idle-but-routed-
        around replica can still reach half-open."""
        _prof.register_thread_name()
        while not self._closed:
            time.sleep(self.probe_ms / 1e3)
            if self._closed:
                return
            try:
                self._probe_once()
            except Exception:  # noqa: BLE001 -- the supervisor survives
                pass

    def _probe_once(self):
        with self._lock:
            states = [st for st in self._states.values() if not st.dead]
        for st in states:
            if not st.replica.alive():
                self._mark_dead(st, reason="probe_dead")
                continue
            sess = st.replica.session
            if sess is not None:
                sstate = str(sess.breaker.state)
                if sstate == "open":
                    if not st.quarantined:
                        with self._lock:
                            if not st.quarantined:
                                st.quarantined = True
                                self.counters["quarantines"] += 1
                    # no traffic reaches an un-ready replica, so ITS
                    # breaker's call-count cooldown would never advance;
                    # the probe loop stands in for the missing callers
                    sess.breaker.allow()
                elif st.quarantined and sstate == "closed":
                    with self._lock:
                        st.quarantined = False

    # -- rollout / scaling --------------------------------------------------
    def rollout(self, new_block, example=None, timeout=30.0):
        """Zero-downtime fleet rollout: one replica at a time, stop
        dispatching to it, wait for its outstanding fleet requests to
        settle, hot-swap its session (warm = no new signature), resume.
        A replica whose drain never completes is marked dead — its work
        fails over — and the rollout continues. Returns the list of
        per-replica swap modes (``"warm"``/``"cold"``/``"dead"``)."""
        with self._lock:
            states = [st for st in sorted(self._states.values(),
                                          key=lambda s: s.index)
                      if not st.dead]
        modes = []
        for st in states:
            with self._lock:
                if st.dead:
                    modes.append("dead")
                    continue
                st.accepting = False
            try:
                if not self._await_outstanding(st, timeout):
                    self._mark_dead(st, reason="rollout_drain_timeout")
                    modes.append("dead")
                    continue
                modes.append(st.replica.swap(new_block, example=example,
                                             timeout=timeout))
            except ServeError:
                self._mark_dead(st, reason="rollout_swap_failed")
                modes.append("dead")
                continue
            finally:
                with self._lock:
                    if not st.dead:
                        st.accepting = True
        with self._lock:
            self.counters["rollouts"] += 1
        return modes

    def _await_outstanding(self, st, timeout):
        """Wait until no fleet request is outstanding on ``st`` (its
        admission is already stopped). True when quiet."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                if not st.outstanding:
                    return True
            time.sleep(0.002)
        with self._lock:
            return not st.outstanding

    def scale_to(self, n, timeout=30.0):
        """Resize the fleet to ``n`` live replicas. Scaling up builds
        replicas through ``factory``; scaling down removes the highest-
        index replicas by graceful drain (a drain that never completes
        becomes a kill + failover — work is never dropped). Returns the
        live count."""
        n = int(n)
        if n < 0:
            raise ServeError(f"scale_to({n}): target must be >= 0")
        # (the JAX package enables its persistent compile cache here so a
        # new replica's warmup replays from disk; the port has none yet,
        # so each new replica pays its factory's warmup)
        while self.replica_count() < n:
            if self.factory is None:
                raise ServeError(
                    f"fleet {self.name!r}: scale_to({n}) needs a replica "
                    "factory")
            with self._lock:
                idx = self._next_idx
            self.add_replica(self.factory(idx))
            with self._lock:
                self.counters["scaled_up"] += 1
        while self.replica_count() > n:
            with self._lock:
                live = sorted((st for st in self._states.values()
                               if not st.dead), key=lambda s: s.index)
                victim = live[-1]
                victim.accepting = False
            self._retire(victim, timeout)
        return self.replica_count()

    def _retire(self, st, timeout):
        """Graceful scale-down of one replica: no new dispatches, wait
        for outstanding to settle, then shut it down clean. Timeout =
        the failover path."""
        if not self._await_outstanding(st, timeout) \
                or not st.replica.drain(min(timeout, 5.0)):
            self._mark_dead(st, reason="scale_down_timeout")
        else:
            with self._lock:
                st.dead = True
            self.monitor.clear(st.index)
            try:
                st.replica.kill()
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self.counters["scaled_down"] += 1
            self._states.pop(st.index, None)

    def autoscale_step(self):
        """Run one autoscaling decision: evaluate the policy over the
        unified export snapshot and apply the target via
        :meth:`scale_to`. Returns the (possibly unchanged) live count.
        No-op without a policy."""
        policy = self.autoscale_policy
        if policy is None:
            return self.replica_count()
        target = int(policy(_export.snapshot(include_aggregates=False),
                            self))
        if target != self.replica_count():
            return self.scale_to(target)
        return self.replica_count()

    # -- probes / stats / lifecycle -----------------------------------------
    def ready(self):
        """Fleet readiness: at least one live, accepting, ready
        replica."""
        if self._closed:
            return False
        with self._lock:
            states = [st for st in self._states.values()
                      if not st.dead and st.accepting]
        return any(st.replica.alive() and st.replica.ready()
                   for st in states)

    def health(self):
        """Fleet health payload for ``/healthz``: per-replica probes
        plus the failover/hedge ledger."""
        with self._lock:
            states = dict(self._states)
            counters = dict(self.counters)
        replicas = {}
        live = 0
        for idx, st in states.items():
            if st.dead:
                replicas[idx] = {"alive": False, "ready": False,
                                 "killed": True}
                continue
            live += 1
            row = st.replica.health()
            row["fleet_breaker"] = st.breaker.snapshot()
            row["accepting"] = st.accepting
            replicas[idx] = row
        return {
            "state": "closed" if self._closed else "serving",
            "ready": self.ready(),
            "live": live,
            "dead": len(states) - live,
            "replicas": replicas,
            "counters": counters,
        }

    def stats(self):
        """Flat-ish gauge dict for ``fleet.<name>.*`` in
        ``export.snapshot()``."""
        with self._lock:
            states = dict(self._states)
            out = dict(self.counters)
            out["inflight"] = len(self._requests)
        live = [st for st in states.values() if not st.dead]
        out["live"] = len(live)
        out["dead"] = len(states) - len(live)
        out["total_load"] = sum(st.replica.load() for st in live)
        rep = {}
        for idx, st in states.items():
            if st.dead:
                rep[idx] = {"alive": 0, "ready": 0, "load": 0}
                continue
            rep[idx] = {
                "alive": int(st.replica.alive()),
                "ready": int(st.replica.ready()),
                "accepting": int(st.accepting),
                "load": st.replica.load(),
                "p99_ms": st.replica.p99_ms(),
                "breaker": str(st.breaker.state),
            }
        out["replica"] = rep
        return out

    def drain(self, timeout=30.0):
        """Graceful preemption drain: stop admitting new requests
        (submit raises :class:`ServiceUnavailable`), wait up to
        ``timeout`` seconds for every in-flight request to settle
        through the normal dispatch/failover machinery, then
        :meth:`close`. Returns True when the fleet drained clean —
        False means the timeout expired and the leftovers settled 503
        through close(). This is the serving half of the SIGTERM
        lifecycle."""
        with self._lock:
            if self._closed:
                return True
            self._draining = True
        deadline = time.monotonic() + float(timeout)
        drained = True
        while True:
            with self._lock:
                pending = len(self._requests)
            if pending == 0:
                break
            if time.monotonic() >= deadline:
                drained = False
                break
            time.sleep(0.01)
        self.close(timeout=max(0.1, deadline - time.monotonic()))
        return drained

    def close(self, timeout=5.0):
        """Shut the fleet down: stop the supervisor, close every
        replica (their leftover work settles 503 through the normal
        fenced/failover machinery, which finds the fleet closed and
        delivers a structural 503)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._supervisor is not None:
            self._supervisor.join(min(timeout, 2 * self.probe_ms / 1e3
                                      + 1.0))
        with self._lock:
            states = list(self._states.values())
        for st in states:
            try:
                st.replica.kill(timeout=timeout)
            except Exception:  # noqa: BLE001
                pass
        _export.unregister_health_provider(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
