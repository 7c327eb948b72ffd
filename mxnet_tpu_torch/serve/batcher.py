"""`DynamicBatcher`: request admission + deadline-bounded batch assembly
(counterpart of ``mxnet_tpu/serve/batcher.py``, host-only).

Single requests enter through :meth:`DynamicBatcher.submit` and come back
as futures; a background flusher thread assembles batches and hands them
to a ``runner`` callable. A batch dispatches when either trigger fires:

* **flush-on-full** — ``max_batch_size`` requests are waiting, or
* **flush-on-deadline** — the *oldest* admitted request has waited
  ``MXNET_SERVE_BATCH_TIMEOUT_MS``; latecomers never extend the deadline
  (no unbounded batch-coalescing tail latency).

Overload safety (all off by default — a priority-free, deadline-free
deployment behaves exactly like the original FIFO batcher):

* **request deadlines** — ``submit(deadline_ms=...)`` (or the
  ``MXNET_SERVE_DEADLINE_MS`` default) attaches an absolute deadline.
  Expired requests are cancelled at every stage boundary — rejected at
  admission, swept out of the queue before each flush, and re-checked at
  settle time so a completion past deadline + ``MXNET_SERVE_DEADLINE_
  GRACE_MS`` becomes a :class:`DeadlineExceeded` (504) instead of a
  silent late delivery the client already gave up on.
* **two-class priority** — ``submit(priority="interactive"|"batch")``.
  Batches assemble interactive-first; under queue pressure the shedding
  is lowest-first: an interactive arrival displaces the *newest* queued
  batch-class request (its future settles with a 503 shed) before the
  interactive class ever sees a reject. ``MXNET_SERVE_BATCH_QUEUE_SHARE``
  caps the queue fraction the batch class may occupy, and
  ``MXNET_SERVE_RATE_LIMIT`` / ``MXNET_SERVE_RATE_BURST`` put a token
  bucket in front of batch-class admission.
* **graceful drain** — :meth:`drain` stops admission and waits for the
  queue and the in-flight batch to settle; :meth:`resume` reopens.
  :meth:`close` with a wedged runner fails every still-queued AND
  in-flight future with 503 instead of leaking them.

Admission control is a hard queue-depth cap (``MXNET_SERVE_MAX_QUEUE``):
beyond it :meth:`submit` fast-rejects with
:class:`~.engine.ServiceUnavailable` *synchronously* — the
overloaded server sheds load in O(1) instead of growing a backlog whose
every entry will miss its SLO anyway. Overload-shaped 503s (full queue,
batch share, rate limit, drain, shed) carry a ``retry_after_ms`` hint
derived from the queue drain rate (depth x per-request service-time
EWMA); structural 503s (shutdown) carry ``None`` so callers can tell
"busy, come back" from "gone, fail over".

Exactly-once admission: ``submit(key=...)`` attaches an idempotency key.
A duplicate submit — same key while the original is queued, in flight,
or recently settled — returns the ORIGINAL future instead of enqueuing
a second copy, so a client retrying an ambiguous failure can never
double-execute a request.

Failure isolation: a runner exception fails the *requests of that batch*
(each future carries the error) and the flusher thread keeps serving —
an injected ``serve:execute`` fault is a per-request 5xx, not a dead
server. A runner may also return an ``Exception`` instance in a result
slot to fail that single request. The ``serve:queue`` fault site fires
inside ``submit`` so a fault plan can fail admission deterministically.
"""
from __future__ import annotations

import collections
import threading
import time
import warnings
from concurrent.futures import Future, InvalidStateError

import torch

from ..profiler import core as _prof
from ..profiler import trace as _trace
from ..resilience import faults as _faults
from .engine import DeadlineExceeded, ServeError, ServiceUnavailable
from .metrics import ServeMetrics

PRIORITIES = ("interactive", "batch")
#: admission order = shed order reversed: the batch class sheds first.
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.
    ``rate <= 0`` means unlimited (every :meth:`take` succeeds)."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n=1.0):
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class _Pending:
    __slots__ = ("payload", "future", "t_enq", "t_dispatch", "priority",
                 "deadline", "key", "trace", "flow", "t_enq_ns",
                 "t_dispatch_ns")

    def __init__(self, payload, priority="interactive", deadline=None,
                 key=None):
        self.payload = payload
        self.future = Future()
        self.t_enq = time.monotonic()
        self.t_dispatch = None
        self.priority = priority
        self.deadline = deadline  # absolute time.monotonic() or None
        self.key = key            # idempotency key or None
        # request-scoped tracing (profiler.trace); None when tracing is
        # off. t_*_ns are perf_counter_ns stamps for retro span emission
        # (t_enq/t_dispatch above are monotonic() — a different clock).
        self.trace = None
        self.flow = None
        self.t_enq_ns = None
        self.t_dispatch_ns = None


def _retire_traced(p, stage, error=None):
    """Close out a pending entry's trace on a non-settle exit path (shed
    / expired / shutdown): the enqueue flow arrow must land somewhere
    (no orphan 's' events) and the trace must read as finished. An entry
    that already dispatched (``t_dispatch_ns`` set) had its arrow and
    queue span emitted by the flusher — only the finish applies."""
    if p.trace is None:
        return
    if p.t_dispatch_ns is None:
        p.trace.flow_in(p.flow, "serve::enqueue")
        p.trace.span_at("serve::queue", p.t_enq_ns,
                        time.perf_counter_ns(), {"outcome": stage})
    p.trace.finish(error=error or stage)


def _settle_future(fut, result=None, error=None):
    """Settle exactly once: a future that already carries an outcome (the
    close-timeout path racing a runner that eventually returned) is left
    untouched. Returns True if this call settled it."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        return False


class DynamicBatcher:
    """Deadline/size-triggered dynamic batching queue.

    Parameters
    ----------
    runner : callable(list) -> list
        Executes one assembled batch of payloads; must return one result
        per payload (an :class:`InferenceSession`-backed closure in the
        serving stack, but any callable works). A result slot holding an
        ``Exception`` instance fails that request alone.
    max_batch_size, timeout_ms, max_queue : optional overrides of the
        ``MXNET_SERVE_*`` config flags.
    device : optional device the runner computes on. When given, the
        flusher thread makes it current (``torch.cuda.set_device``) and
        runs the runner under ``torch.inference_mode()``: a new thread
        inherits neither from the thread that built the batcher.
    """

    def __init__(self, runner, max_batch_size=None, timeout_ms=None,
                 max_queue=None, name="batcher", metrics=None, start=True,
                 device=None):
        from .. import config

        self.runner = runner
        self.device = (torch.device(device) if device is not None
                       else None)
        self.max_batch_size = int(max_batch_size if max_batch_size is not None
                                  else config.get("MXNET_SERVE_MAX_BATCH"))
        if self.max_batch_size < 1:
            raise ServeError(
                f"max_batch_size must be >= 1, got {self.max_batch_size}")
        self.timeout_s = (timeout_ms if timeout_ms is not None
                          else config.get("MXNET_SERVE_BATCH_TIMEOUT_MS")) / 1e3
        self.max_queue = int(max_queue if max_queue is not None
                             else config.get("MXNET_SERVE_MAX_QUEUE"))
        if self.max_queue < 0:
            raise ServeError(
                f"max_queue must be >= 0, got {self.max_queue}")
        # overload knobs, resolved once (submit runs per request and must
        # not re-read the environment)
        self.default_deadline_s = (
            config.get("MXNET_SERVE_DEADLINE_MS") or 0.0) / 1e3
        self.deadline_grace_s = (
            config.get("MXNET_SERVE_DEADLINE_GRACE_MS") or 0.0) / 1e3
        share = float(config.get("MXNET_SERVE_BATCH_QUEUE_SHARE"))
        if not 0.0 <= share <= 1.0:
            raise ServeError(
                f"MXNET_SERVE_BATCH_QUEUE_SHARE must be in [0, 1], "
                f"got {share}")
        self.batch_queue_cap = int(self.max_queue * share)
        self.rate_limiter = TokenBucket(
            config.get("MXNET_SERVE_RATE_LIMIT"),
            config.get("MXNET_SERVE_RATE_BURST"))
        self.name = name
        self.metrics = metrics or ServeMetrics(name)
        self._queue = []               # FIFO of _Pending (guarded by _cond)
        self._inflight = []            # batch currently inside the runner
        self._cond = threading.Condition()
        self._closed = False
        self._draining = False
        self._thread = None
        # idempotency keys (exactly-once admission): key -> live future
        # while unsettled, then retained in a bounded settled map so a
        # duplicate submit AFTER settlement returns the same outcome
        # instead of recomputing it
        self._keyed = {}
        self._settled_keys = collections.OrderedDict()
        self._settled_cap = 2048
        self.duplicate_submits = 0
        # per-request amortized service time EWMA (ms) — the drain-rate
        # estimate behind the retry_after_ms hint on overload 503s
        self._svc_ms = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True,
            name=f"mxtpu-serve-batcher[{self.name}]")
        self._thread.start()

    def close(self, timeout=5.0):
        """Stop the flusher. Already-admitted requests are drained first;
        anything still queued after the drain fails with 503. If the
        flusher misses the join deadline (a runner wedged mid-batch),
        every still-queued future AND the wedged batch's futures fail
        with 503 — nothing is left to hang forever. Should the wedged
        runner later return, its settle attempt finds the futures already
        carrying the 503 and is dropped (exactly-once settle)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        stuck = []
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout)
            wedged = self._thread.is_alive()
        with self._cond:
            # a wedged flusher (runner hung) OR a dead one (a `die` fault
            # is a BaseException — it kills the thread without running
            # _settle) both strand the in-flight batch; rescue it either
            # way. A cleanly-exited flusher left _inflight empty.
            stuck, self._inflight = self._inflight, []
            leftovers, self._queue = self._queue, []
            self.metrics.set_queue_depth(0)
        if stuck and wedged:
            warnings.warn(
                f"batcher {self.name!r}: flusher did not join within "
                f"{timeout}s (runner wedged mid-batch); failing its "
                f"{len(stuck)} in-flight and {len(leftovers)} queued "
                "request(s) with 503 instead of leaking them",
                RuntimeWarning, stacklevel=2)
        for p in stuck + leftovers:
            err = ServiceUnavailable(
                f"batcher {self.name!r} shut down before dispatch")
            _retire_traced(p, "shutdown", err)
            _settle_future(p.future, error=err)
            self._key_done(p)

    def drain(self, timeout=30.0):
        """Stop admission and wait until the queue AND the in-flight batch
        are empty. Returns True once quiesced (every admitted future has
        settled), False on timeout. Admission stays stopped either way;
        :meth:`resume` reopens it."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            self._draining = True
            self._cond.notify_all()   # wake the flusher: flush NOW
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def resume(self):
        """Reopen admission after :meth:`drain`."""
        with self._cond:
            self._draining = False
            self._cond.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- admission ----------------------------------------------------------
    def _resolve_deadline(self, deadline_ms):
        if deadline_ms is not None:
            return (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms > 0 else None)
        if self.default_deadline_s > 0:
            return time.monotonic() + self.default_deadline_s
        return None

    def _dedupe_locked(self, key):
        """Return the existing future for ``key`` (live or settled) or
        None. Caller holds ``_cond``."""
        fut = self._keyed.get(key)
        if fut is None:
            fut = self._settled_keys.get(key)
        return fut

    def submit(self, payload, priority="interactive", deadline_ms=None,
               key=None):
        """Admit one request; returns a :class:`concurrent.futures.Future`.

        ``priority`` is ``"interactive"`` (default — never shed in favor
        of batch work) or ``"batch"`` (sheds first under pressure).
        ``deadline_ms`` attaches a relative deadline (<= 0 disables even
        when ``MXNET_SERVE_DEADLINE_MS`` sets a default).
        ``key`` is an optional idempotency key: a resubmit of a key that
        is already queued, in flight, or recently settled returns the
        ORIGINAL request's future — it never enqueues a second copy, so a
        retry after an ambiguous failure cannot double-execute.

        Raises synchronously: :class:`ServiceUnavailable` when the queue
        is full of equal-or-higher-priority work, the batch-class share or
        token bucket rejects, or the batcher is closed/draining;
        :class:`DeadlineExceeded` when the deadline is already in the
        past at admission."""
        if priority not in _PRIORITY_RANK:
            raise ServeError(
                f"unknown priority {priority!r}; use one of {PRIORITIES}")
        if key is not None:
            # dedupe BEFORE the fault site and deadline check: a duplicate
            # must resolve to the original outcome, not inject a second
            # fault or 504 against a deadline the first copy already beat
            with self._cond:
                fut = self._dedupe_locked(key)
                if fut is not None:
                    self.duplicate_submits += 1
                    return fut
        t_sub_ns = time.perf_counter_ns() if _trace.ENABLED else 0
        # admission fault site OUTSIDE the lock: an injected delay models
        # a slow admission path, not a queue-lock convoy
        _faults.fault_point("serve:queue", {"batcher": self.name,
                                            "priority": priority})
        deadline = self._resolve_deadline(deadline_ms)
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            self.metrics.observe_deadline("admit", priority)
            raise DeadlineExceeded(
                f"batcher {self.name!r}: request deadline expired "
                "before admission")
        shed = None
        shed_hint = None
        with self._cond:
            if key is not None:
                # authoritative re-check under the admission lock (two
                # racing duplicates may both pass the pre-check above)
                fut = self._dedupe_locked(key)
                if fut is not None:
                    self.duplicate_submits += 1
                    return fut
            if self._closed:
                # structural: no retry_after_ms — waiting won't help
                raise ServiceUnavailable(
                    f"batcher {self.name!r} is shut down")
            if self._draining:
                self.metrics.observe_reject()
                raise self._shed_503(
                    f"batcher {self.name!r} is draining; no new work "
                    "admitted until resume()", self._drain_eta_ms_locked())
            if priority == "batch" and self.batch_queue_cap < self.max_queue:
                n_batch = sum(1 for p in self._queue
                              if p.priority == "batch")
                if n_batch >= self.batch_queue_cap:
                    self.metrics.observe_shed("batch", reason="share")
                    raise self._shed_503(
                        f"batcher {self.name!r}: batch-class queue share "
                        f"({self.batch_queue_cap} of {self.max_queue}) is "
                        "full; shed", self._drain_eta_ms_locked())
            if len(self._queue) >= self.max_queue:
                # shed-lowest-first: an interactive arrival displaces the
                # NEWEST queued lower-priority request (newest: it has
                # waited least, so killing it wastes the least invested
                # queue time) instead of being rejected
                victim_idx = None
                if priority == "interactive":
                    for i in range(len(self._queue) - 1, -1, -1):
                        if _PRIORITY_RANK[self._queue[i].priority] \
                                > _PRIORITY_RANK[priority]:
                            victim_idx = i
                            break
                if victim_idx is None:
                    self.metrics.observe_reject()
                    if priority == "batch":
                        self.metrics.observe_shed("batch",
                                                  reason="pressure")
                    raise self._shed_503(
                        f"batcher {self.name!r} queue is full "
                        f"({self.max_queue} waiting); shed load upstream",
                        self._drain_eta_ms_locked())
                shed = self._queue.pop(victim_idx)
                shed_hint = self._drain_eta_ms_locked()
            # rate-limit LAST, after every other reject: a token must only
            # be spent on a request that is actually admitted — otherwise
            # retries against a full/draining batcher drain the bucket and
            # the effective rate becomes attempts, not admissions
            if priority == "batch" and not self.rate_limiter.take():
                if shed is not None:
                    # can't happen (only interactive displaces), but never
                    # lose a popped victim
                    self._queue.append(shed)
                self.metrics.observe_shed("batch", reason="rate")
                raise self._shed_503(
                    f"batcher {self.name!r}: batch-class token bucket "
                    f"empty (MXNET_SERVE_RATE_LIMIT="
                    f"{self.rate_limiter.rate:g}/s); shed",
                    1e3 / self.rate_limiter.rate)
            p = _Pending(payload, priority=priority, deadline=deadline,
                         key=key)
            if t_sub_ns:
                # trace set up BEFORE the entry is visible to the flusher
                # (a half-traced entry would leak an unclosed flow arrow)
                tr = _trace.start_trace(f"serve.request[{self.name}]",
                                        args={"priority": priority})
                if tr is not None:
                    p.trace = tr
                    p.t_enq_ns = time.perf_counter_ns()
                    tr.span_at("serve::admit", t_sub_ns, p.t_enq_ns,
                               {"priority": priority})
                    p.flow = tr.flow_out("serve::enqueue")
            self._queue.append(p)
            if key is not None:
                self._keyed[key] = p.future
            self.metrics.set_queue_depth(len(self._queue))
            self._cond.notify()
        if shed is not None:
            self.metrics.observe_shed(shed.priority, reason="pressure")
            err = self._shed_503(
                f"batcher {self.name!r}: shed under queue pressure to "
                "admit higher-priority work", shed_hint)
            _retire_traced(shed, "shed", err)
            _settle_future(shed.future, error=err)
            self._key_done(shed)
        return p.future

    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    def _drain_eta_ms_locked(self):
        """Estimate (ms) how long the current backlog takes to drain:
        queue depth x amortized per-request service time (EWMA from real
        settles), plus one batch-assembly window. Before the first settle
        the timeout alone stands in. Caller holds ``_cond``."""
        svc = self._svc_ms if self._svc_ms is not None \
            else self.timeout_s * 1e3
        return len(self._queue) * svc + self.timeout_s * 1e3

    @staticmethod
    def _shed_503(msg, retry_after_ms):
        """An overload-shaped 503: carries a ``retry_after_ms`` hint
        derived from the queue drain rate, so a client backs off just
        long enough instead of guessing.
        Structural 503s — shutdown — deliberately carry None."""
        err = ServiceUnavailable(msg)
        err.retry_after_ms = max(1.0, float(retry_after_ms))
        return err

    def _key_done(self, p):
        """Retire a settled entry's idempotency key: drop the live
        mapping and retain the settled future in a bounded LRU so a
        late duplicate still gets the original outcome."""
        if p.key is None:
            return
        with self._cond:
            self._keyed.pop(p.key, None)
            self._settled_keys[p.key] = p.future
            self._settled_keys.move_to_end(p.key)
            while len(self._settled_keys) > self._settled_cap:
                self._settled_keys.popitem(last=False)

    # -- flusher ------------------------------------------------------------
    def _sweep_expired_locked(self, now):
        """Remove queue entries whose deadline has passed (caller holds
        ``_cond``); returns them for settling outside the lock."""
        expired = [p for p in self._queue
                   if p.deadline is not None and now >= p.deadline]
        if expired:
            dead = set(id(p) for p in expired)
            self._queue = [p for p in self._queue if id(p) not in dead]
        return expired

    def _take_batch(self):
        """Block until a batch is due; returns (batch, expired) — expired
        entries are settled by the caller with DeadlineExceeded. Flush
        triggers: size >= max_batch_size, the oldest entry older than
        timeout_s, or drain/close (dispatch NOW). Batches assemble
        interactive-first (stable within each class)."""
        with self._cond:
            while True:
                now = time.monotonic()
                expired = self._sweep_expired_locked(now)
                if expired:
                    self.metrics.set_queue_depth(len(self._queue))
                    return [], expired
                if self._queue:
                    # sort only on the dispatch branches — a wakeup that
                    # goes back to waiting must not pay O(n log n) under
                    # the lock submitters contend for
                    if len(self._queue) >= self.max_batch_size:
                        ordered = sorted(
                            self._queue,
                            key=lambda p: _PRIORITY_RANK[p.priority])
                        batch = ordered[:self.max_batch_size]
                        taken = set(id(p) for p in batch)
                        self._queue = [p for p in self._queue
                                       if id(p) not in taken]
                        self._inflight = list(batch)
                        self.metrics.set_queue_depth(len(self._queue))
                        return batch, []
                    age = now - self._queue[0].t_enq
                    remaining = self.timeout_s - age
                    if remaining <= 0 or self._closed or self._draining:
                        # flush deadline hit — or drain/shutdown: dispatch
                        # what's queued NOW instead of sitting it out
                        batch = sorted(
                            self._queue,
                            key=lambda p: _PRIORITY_RANK[p.priority])
                        self._queue = []
                        self._inflight = list(batch)
                        self.metrics.set_queue_depth(0)
                        return batch, []
                    # wake early enough to expire the nearest deadline
                    nearest = min((p.deadline - now for p in self._queue
                                   if p.deadline is not None),
                                  default=remaining)
                    self._cond.wait(max(1e-4, min(remaining, nearest)))
                elif self._closed:
                    return [], []
                else:
                    self._cond.wait(0.5)

    def _flush_loop(self):
        _prof.register_thread_name()
        if self.device is None:
            self._flush_batches()
            return
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._flush_batches()

    def _flush_batches(self):
        while True:
            batch, expired = self._take_batch()
            if expired:
                self.settle_expired(expired)
                continue
            if not batch:
                if self._closed:
                    return
                continue
            now = time.monotonic()
            rep = None  # one traced request represents the batch downstream
            for p in batch:
                p.t_dispatch = now
                if p.trace is not None:
                    # land the enqueue arrow on THIS thread + emit the
                    # queue span retroactively from the stored ns stamps
                    p.t_dispatch_ns = time.perf_counter_ns()
                    p.trace.flow_in(p.flow, "serve::enqueue")
                    p.trace.span_at("serve::queue", p.t_enq_ns,
                                    p.t_dispatch_ns,
                                    {"batch_size": len(batch)})
                    if rep is None:
                        rep = p.trace
            self.metrics.observe_batch(len(batch), self.max_batch_size)
            try:
                with _trace.activate(rep):
                    results = self.runner([p.payload for p in batch])
                if len(results) != len(batch):
                    raise ServiceUnavailable(
                        f"batcher runner returned {len(results)} results "
                        f"for a {len(batch)}-request batch")
            except Exception as exc:  # pylint: disable=broad-except
                # (BaseException — e.g. an injected SimulatedWorkerDeath —
                # still kills the flusher: worker-death semantics belong
                # to the resilience harness, not per-request errors.)
                # the batch fails, the SERVER does not: every affected
                # request gets the error on its future and the loop
                # continues (the test for an injected serve:execute fault)
                self._settle(batch, error=exc)
                continue
            self._settle(batch, results=results)

    def _settle(self, batch, results=None, error=None):
        done = time.monotonic()
        done_ns = time.perf_counter_ns()
        if error is None and batch:
            # feed the drain-rate estimator only from real completions:
            # failed batches say nothing about healthy service time
            per_req = (done - batch[0].t_dispatch) * 1e3 / len(batch)
            self._svc_ms = per_req if self._svc_ms is None \
                else 0.7 * self._svc_ms + 0.3 * per_req
        for i, p in enumerate(batch):
            queue_ms = (p.t_dispatch - p.t_enq) * 1e3
            exec_ms = (done - p.t_dispatch) * 1e3
            out, exc = None, error
            if exc is None:
                out = results[i]
                if isinstance(out, BaseException):
                    # per-request failure returned in a result slot
                    out, exc = None, out
            deadline_ok = True
            if exc is None and p.deadline is not None and done > p.deadline:
                if done > p.deadline + self.deadline_grace_s:
                    # the client's budget ran out mid-execution: a 504,
                    # never a silent late delivery
                    self.metrics.observe_deadline("execute", p.priority)
                    exc = DeadlineExceeded(
                        f"batcher {self.name!r}: completed "
                        f"{(done - p.deadline) * 1e3:.1f}ms past deadline "
                        f"(grace {self.deadline_grace_s * 1e3:.0f}ms)")
                else:
                    deadline_ok = False  # delivered, but counted late
            self.metrics.observe_request(queue_ms, exec_ms,
                                         ok=exc is None,
                                         priority=p.priority,
                                         deadline_ok=deadline_ok)
            if p.trace is not None:
                p.trace.span_at("serve::execute", p.t_dispatch_ns, done_ns,
                                {"exec_ms": round(exec_ms, 3),
                                 "ok": exc is None})
                p.trace.finish(error=exc)
            _settle_future(p.future, result=out, error=exc)
            self._key_done(p)
        with self._cond:
            self._inflight = []
            self._cond.notify_all()

    # -- iteration-level consumer API ---------------------------------------
    # The continuous-batching scheduler (serve.scheduler.ContinuousEngine)
    # consumes the queue directly between decode steps instead of through
    # the flusher thread: construct with ``start=False`` and drive
    # take() / settle_one() / settle_expired() / requeue(). Admission
    # semantics (priority classes, deadlines, shedding, idempotency keys,
    # retry_after_ms taxonomy) are byte-for-byte the same — only batch
    # *assembly* moves from the flusher's size/timeout triggers to the
    # scheduler's free-slot capacity between decode iterations.

    def take(self, max_n, wait_s=0.0):
        """Pop up to ``max_n`` queued requests, interactive-first (stable
        within each class — identical ordering to :meth:`_take_batch`).
        Returns ``(batch, expired)``: expired entries swept from the
        queue must be settled by the caller via :meth:`settle_expired`
        (and when any are returned the batch is empty — one concern per
        call). Blocks up to ``wait_s`` for work; ``([], [])`` means
        nothing was due or the batcher closed. Taken entries sit in the
        in-flight set (visible to :meth:`drain` / :meth:`close`) until
        :meth:`settle_one` or :meth:`requeue` removes them."""
        deadline = time.monotonic() + max(0.0, float(wait_s))
        with self._cond:
            while True:
                now = time.monotonic()
                expired = self._sweep_expired_locked(now)
                if expired:
                    self.metrics.set_queue_depth(len(self._queue))
                    return [], expired
                if self._queue and max_n > 0:
                    ordered = sorted(
                        self._queue,
                        key=lambda p: _PRIORITY_RANK[p.priority])
                    batch = ordered[:int(max_n)]
                    taken = set(id(p) for p in batch)
                    self._queue = [p for p in self._queue
                                   if id(p) not in taken]
                    self._inflight.extend(batch)
                    self.metrics.set_queue_depth(len(self._queue))
                    break
                remaining = deadline - now
                if remaining <= 0 or self._closed:
                    return [], []
                self._cond.wait(remaining)
        now = time.monotonic()
        for p in batch:
            p.t_dispatch = now
            if p.trace is not None and p.t_dispatch_ns is None:
                # first dispatch only: a requeued entry already landed
                # its enqueue arrow and queue span
                p.t_dispatch_ns = time.perf_counter_ns()
                p.trace.flow_in(p.flow, "serve::enqueue")
                p.trace.span_at("serve::queue", p.t_enq_ns,
                                p.t_dispatch_ns,
                                {"batch_size": len(batch)})
        self.metrics.observe_batch(len(batch), self.max_batch_size)
        return batch, []

    def requeue(self, p):
        """Put an in-flight entry back at the FRONT of the queue — the
        scheduler's answer to :class:`~.engine.PoolExhausted` at admit
        time: the request keeps its place in line and is re-taken the
        moment retirements free KV pages. On a closed batcher the entry
        settles with a structural 503 instead of re-entering a queue
        nobody will ever drain."""
        closed = False
        with self._cond:
            try:
                self._inflight.remove(p)
            except ValueError:
                pass
            closed = self._closed
            if not closed:
                self._queue.insert(0, p)
                self.metrics.set_queue_depth(len(self._queue))
            self._cond.notify_all()
        if closed:
            err = ServiceUnavailable(
                f"batcher {self.name!r} shut down before dispatch")
            _retire_traced(p, "shutdown", err)
            _settle_future(p.future, error=err)
            self._key_done(p)

    def settle_expired(self, expired):
        """Settle queue-expired entries (the second element of
        :meth:`take` / :meth:`_take_batch`) with the 504 taxonomy:
        ``observe_deadline("queue")``, a failed-request sample, a
        :class:`DeadlineExceeded` on the future."""
        now = time.monotonic()
        for p in expired:
            self.metrics.observe_deadline("queue", p.priority)
            self.metrics.observe_request(
                (now - p.t_enq) * 1e3, 0.0, ok=False,
                priority=p.priority)
            err = DeadlineExceeded(
                f"batcher {self.name!r}: deadline expired after "
                f"{(now - p.t_enq) * 1e3:.1f}ms in queue")
            _retire_traced(p, "expired", err)
            _settle_future(p.future, error=err)
            self._key_done(p)
        with self._cond:
            # the sweep may have emptied the queue: wake drain()
            # waiters now, not at their timeout
            self._cond.notify_all()

    def settle_one(self, p, result=None, error=None):
        """Per-request settle for iteration-level consumers — requests
        retire one at a time as they finish, not as a batch. Applies the
        same deadline+grace recheck, metrics, tracing, exactly-once
        future semantics, and service-time EWMA feed as the flusher's
        :meth:`_settle`, then removes the entry from the in-flight set
        (waking :meth:`drain`)."""
        done = time.monotonic()
        done_ns = time.perf_counter_ns()
        t_disp = p.t_dispatch if p.t_dispatch is not None else done
        queue_ms = (t_disp - p.t_enq) * 1e3
        exec_ms = (done - t_disp) * 1e3
        exc = error
        if exc is None:
            self._svc_ms = exec_ms if self._svc_ms is None \
                else 0.7 * self._svc_ms + 0.3 * exec_ms
        deadline_ok = True
        if exc is None and p.deadline is not None and done > p.deadline:
            if done > p.deadline + self.deadline_grace_s:
                self.metrics.observe_deadline("execute", p.priority)
                exc = DeadlineExceeded(
                    f"batcher {self.name!r}: completed "
                    f"{(done - p.deadline) * 1e3:.1f}ms past deadline "
                    f"(grace {self.deadline_grace_s * 1e3:.0f}ms)")
            else:
                deadline_ok = False  # delivered, but counted late
        self.metrics.observe_request(queue_ms, exec_ms,
                                     ok=exc is None,
                                     priority=p.priority,
                                     deadline_ok=deadline_ok)
        if p.trace is not None:
            p.trace.span_at("serve::execute",
                            p.t_dispatch_ns or done_ns, done_ns,
                            {"exec_ms": round(exec_ms, 3),
                             "ok": exc is None})
            p.trace.finish(error=exc)
        _settle_future(p.future,
                       result=result if exc is None else None,
                       error=exc)
        self._key_done(p)
        with self._cond:
            try:
                self._inflight.remove(p)
            except ValueError:
                pass
            self._cond.notify_all()

    def stats(self):
        out = self.metrics.snapshot()
        out["queue_depth"] = self.queue_depth()
        out["duplicate_submits"] = self.duplicate_submits
        return out
