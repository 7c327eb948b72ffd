"""Retry/backoff, the execution watchdog and the circuit breaker (the
port's own copy of ``mxnet_tpu/resilience/retry.py``, host-only).

Classification first: a retry layer that retries *everything* turns real
bugs into slow bugs. :func:`is_transient` says yes only for (a) injected
:class:`~.faults.TransientFaultError`, (b) runtime errors whose message
carries a transient grpc-style status or a dropped connection
(RESOURCE_EXHAUSTED, UNAVAILABLE, ABORTED, DEADLINE_EXCEEDED, connection
resets), matched on the message as in the JAX package. Everything else —
shape errors, user bugs, injected fatals, a lost device, a timed-out body
— re-raises on the first attempt.

Pieces:

* :class:`RetryPolicy` / :func:`call_with_retry` — bounded exponential
  backoff. ``MXNET_COMPILE_MAX_RETRIES`` and
  ``MXNET_COLLECTIVE_MAX_RETRIES`` size the two named policies;
  ``MXNET_RETRY_BASE_DELAY_MS`` / ``MXNET_RETRY_MAX_DELAY_MS`` shape the
  backoff curve. Every retry emits a ``resilience::retry`` instant on the
  profiler bus and bumps the ``resilience.retries`` counter.
* :func:`run_with_watchdog` — runs a body on a fresh daemon thread per
  engaged call and bounds the wait: a hung body becomes a diagnosable
  :class:`CollectiveTimeoutError` instead of an infinite hang. Disabled
  (timeout 0) it calls the body inline — no thread. The body runs on
  another thread, so it must set whatever per-thread state it needs
  (``torch.cuda.set_device``, ``torch.inference_mode``): neither is
  inherited (``serve.engine.InferenceSession.run`` does both). On timeout
  the thread is still running (Python cannot preempt it) and leaks as a
  daemon; the caller degrades (circuit breaker) rather than re-entering
  the path at once.
* :class:`CircuitBreaker` — closed → open after K consecutive failures,
  open → half-open after a call-count cooldown (deterministic under test),
  half-open lets ONE probe through and closes on success / re-opens on
  failure. State transitions emit ``resilience::breaker`` instants, and
  opening dumps the flight recorder.
"""
from __future__ import annotations

import threading
import time
import weakref

from ..base import MXNetError
from ..profiler import core as _prof
from ..profiler import recorder as _recorder
from . import counters as _counters
from .faults import ChipLostError, InjectedFaultError, \
    SimulatedWorkerDeath, TransientFaultError


class CollectiveTimeoutError(MXNetError):
    """A watched body exceeded its timeout (a hung execution or
    collective)."""


# message fragments marking transient runtime errors (grpc-style status
# prefixes and transport drops, the JAX package's list)
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "Connection reset",
    "remote_compile",
    "Socket closed",
    "failed to connect",
    "Failed to connect",
)


def is_transient(exc) -> bool:
    """Retryable? Injected transients yes, injected fatals no, runtime
    errors by grpc-status message category."""
    if isinstance(exc, TransientFaultError):
        return True
    if isinstance(exc, (InjectedFaultError, SimulatedWorkerDeath,
                        ChipLostError)):
        # a lost chip is gone, not busy — retrying the collective in
        # place would just re-fail; mesh-loss recovery (resilience.
        # elastic) is the correct continuation, not backoff
        return False
    if isinstance(exc, CollectiveTimeoutError):
        # a hung collective is not safely re-runnable in place: the hung
        # attempt still owns the device stream — degrade, don't retry
        return False
    msg = str(exc)
    return any(m in msg for m in _TRANSIENT_MARKERS)


class RetryPolicy:
    """Bounded exponential backoff: delay_i = min(base * 2**i, max)."""

    def __init__(self, max_retries=2, base_delay_s=0.005, max_delay_s=0.25,
                 classify=is_transient):
        self.max_retries = int(max_retries)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.classify = classify

    def delay(self, attempt) -> float:
        return min(self.base_delay_s * (2 ** attempt), self.max_delay_s)


def _env_policy(retries_flag):
    from .. import config

    return RetryPolicy(
        max_retries=config.get(retries_flag),
        base_delay_s=config.get("MXNET_RETRY_BASE_DELAY_MS") / 1e3,
        max_delay_s=config.get("MXNET_RETRY_MAX_DELAY_MS") / 1e3)


def compile_policy() -> RetryPolicy:
    """Policy for builds (MXNET_COMPILE_MAX_RETRIES)."""
    return _env_policy("MXNET_COMPILE_MAX_RETRIES")


def collective_policy() -> RetryPolicy:
    """Policy for collectives (MXNET_COLLECTIVE_MAX_RETRIES)."""
    return _env_policy("MXNET_COLLECTIVE_MAX_RETRIES")


def call_with_retry(fn, site, policy=None, on_retry=None):
    """Run ``fn()``; on a transient failure back off and re-run, up to
    ``policy.max_retries`` extra attempts. The last failure re-raises
    unchanged (callers keep their existing except clauses)."""
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        try:
            return fn()
        except SimulatedWorkerDeath:
            raise
        except Exception as exc:
            if attempt >= policy.max_retries or not policy.classify(exc):
                raise
            _counters.incr("resilience.retries")
            if _prof.ENABLED:
                _prof.record_instant(
                    f"resilience::retry({site})", "resilience",
                    args={"attempt": attempt + 1,
                          "error": f"{type(exc).__name__}: {exc}"[:200]})
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(policy.delay(attempt))
            attempt += 1


def retry_count() -> int:
    """Process-wide successful-retry counter (bench/tests)."""
    return _counters.get("resilience.retries")


# -- watchdog ---------------------------------------------------------------


def collective_timeout() -> float:
    """MXNET_COLLECTIVE_TIMEOUT in seconds; 0/unset disables the watchdog."""
    from .. import config

    return config.get("MXNET_COLLECTIVE_TIMEOUT") or 0.0


# Orphan accounting: a timed-out watchdog body cannot be preempted — the
# abandoned thread keeps running and CAN STILL MUTATE STATE (write a
# KV-cache ring, launch kernels) after the caller has already degraded. That risk must be visible, not silent:
# every abandonment counts into ``resilience.watchdog_orphans`` (total)
# and a live gauge that decrements when an orphan eventually finishes.
_orphan_lock = threading.Lock()
_orphans_live = 0


def watchdog_orphans():
    """Orphaned watchdog-body accounting: ``{"total": every body ever
    abandoned at timeout, "live": those still running right now}``. A
    nonzero ``live`` means abandoned executions may still mutate state
    behind the serving path (surfaced via ``InferenceSession.stats()`` and
    ``health()``)."""
    with _orphan_lock:
        live = _orphans_live
    return {"total": _counters.get("resilience.watchdog_orphans"),
            "live": live}


def run_with_watchdog(fn, timeout_s, site="collective"):
    """Run ``fn()`` bounded by ``timeout_s``; raise
    :class:`CollectiveTimeoutError` with a diagnosis instead of hanging.
    ``timeout_s <= 0`` calls ``fn()`` inline (no thread, no overhead).

    A fresh **daemon** thread per engaged call: a truly hung body leaks
    its thread without blocking interpreter exit or poisoning a
    shared pool the next probe would queue behind. Each abandonment is
    counted (:func:`watchdog_orphans`) and warned about at 1/10/100/...
    occurrences — the orphaned body keeps running and can still mutate
    state, so a climbing orphan count is an operator signal, not noise.
    """
    global _orphans_live
    if not timeout_s or timeout_s <= 0:
        return fn()
    box = {}
    done = threading.Event()

    def body():
        global _orphans_live
        _prof.register_thread_name()
        try:
            box["out"] = fn()
        except BaseException as exc:  # rethrown on the caller thread
            box["exc"] = exc
        finally:
            with _orphan_lock:
                box["done"] = True
                if box.get("abandoned"):
                    # the waiter gave up on us long ago; retire the orphan
                    _orphans_live -= 1
            done.set()

    t = threading.Thread(target=body, daemon=True,
                         name=f"mxtpu-watchdog[{site}]")
    t.start()
    if not done.wait(timeout_s):
        with _orphan_lock:
            timed_out = not box.get("done")
            if timed_out:
                box["abandoned"] = True
                _orphans_live += 1
        if timed_out:
            _counters.incr("resilience.watchdog_timeouts")
            _counters.incr("resilience.watchdog_orphans")
            n = _counters.get("resilience.watchdog_orphans")
            if _prof.ENABLED:
                # body_alive distinguishes a genuinely hung body (the
                # daemon thread is still running) from one that died
                # between the timeout and this probe
                _prof.record_instant(
                    f"resilience::watchdog_timeout({site})", "resilience",
                    args={"timeout_s": timeout_s, "orphans": n,
                          "body_alive": t.is_alive()})
            _recorder.dump("watchdog_timeout",
                           args={"site": site, "timeout_s": timeout_s,
                                 "orphans": n})
            if _counters.should_warn(n):
                import warnings

                warnings.warn(
                    f"watchdog abandoned a timed-out body at {site} "
                    f"({n} orphan(s) so far, "
                    f"{watchdog_orphans()['live']} still running) — the "
                    "orphaned execution keeps running and can still "
                    "mutate state; see watchdog_orphans()",
                    RuntimeWarning, stacklevel=2)
            raise CollectiveTimeoutError(
                f"{site} did not complete within {timeout_s}s — a hung "
                "execution or collective. The attempt's thread is still "
                "running; the caller fails fast (a 503) instead of "
                "re-entering the path.")
        # the body finished between the wait timing out and the lock —
        # not an orphan, use its result
    if "exc" in box:
        raise box["exc"]
    return box.get("out")


# -- circuit breaker --------------------------------------------------------

# live breakers, for the unified export surface (profiler.export pulls
# breaker_states() so a breaker's state is a scrapeable gauge instead of
# something only observable by provoking a call); weak so the registry
# never pins a retired session's breaker
_breakers: "weakref.WeakSet" = weakref.WeakSet()


class BreakerState(str):
    """The breaker's state as a string (``== "closed"`` comparisons keep
    working) that is *also callable*: ``breaker.state()`` returns the
    structured form ``{"state", "cooldown_remaining", "trips",
    "consecutive_failures"}`` — ``cooldown_remaining`` is how many more
    denied calls an open breaker sits out before half-open re-probe."""

    def __new__(cls, state, cooldown_remaining=0, trips=0,
                consecutive_failures=0):
        obj = super().__new__(cls, state)
        obj.cooldown_remaining = int(cooldown_remaining)
        obj.trips = int(trips)
        obj.consecutive_failures = int(consecutive_failures)
        return obj

    def __call__(self):
        return {"state": str(self),
                "cooldown_remaining": self.cooldown_remaining,
                "trips": self.trips,
                "consecutive_failures": self.consecutive_failures}


def breaker_states():
    """``{breaker_name: state()}`` over every live CircuitBreaker (the
    per-breaker gauge surface behind ``profiler.export.snapshot()``).
    Same-named breakers merge last-writer-wins."""
    return {b.name: b.state() for b in list(_breakers)}


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a call-count cooldown.

    closed: calls allowed; ``failure_threshold`` consecutive ``record_failure``
    calls trip it open. open: ``allow()`` is False for ``cooldown_calls``
    queries, then half-open. half-open: exactly one probe allowed;
    ``record_success`` closes, ``record_failure`` re-opens.
    """

    def __init__(self, failure_threshold=3, cooldown_calls=8, name="breaker"):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_calls = int(cooldown_calls)
        self.name = name
        self._lock = threading.Lock()
        self._state = "closed"
        self.consecutive_failures = 0
        self.trips = 0
        self._denied = 0          # denials since the breaker opened
        self._probe_out = False   # a half-open probe is in flight
        _breakers.add(self)

    @property
    def state(self):
        """Current state as a :class:`BreakerState`: compares as the plain
        string (``breaker.state == "open"``) and calls as the structured
        readout (``breaker.state()`` -> dict with cooldown_remaining)."""
        with self._lock:
            cooldown = (max(0, self.cooldown_calls - self._denied)
                        if self._state == "open" else 0)
            return BreakerState(self._state, cooldown_remaining=cooldown,
                                trips=self.trips,
                                consecutive_failures=self
                                .consecutive_failures)

    def _transition(self, state):
        self._state = state
        if _prof.ENABLED:
            _prof.record_instant(f"resilience::breaker({self.name})",
                                 "resilience", args={"state": state})
        _recorder.note("breaker", self.name, {"state": state})
        if state == "open":
            # a tripped breaker is an incident: dump the flight recorder
            # (the ring carries the failures that tripped it)
            _recorder.dump("breaker_open",
                           args={"breaker": self.name,
                                 "failures": self.consecutive_failures,
                                 "trips": self.trips})

    def allow(self) -> bool:
        """May the protected path run now? (also advances the cooldown)"""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                self._denied += 1
                if self._denied >= self.cooldown_calls:
                    self._transition("half_open")
                    self._probe_out = False
                return False
            # half-open: one probe at a time
            if self._probe_out:
                return False
            self._probe_out = True
            return True

    def release_probe(self):
        """The allowed call never actually exercised the protected path
        (e.g. ineligible input): free the half-open probe slot without a
        state transition."""
        with self._lock:
            self._probe_out = False

    def record_success(self):
        with self._lock:
            self.consecutive_failures = 0
            self._probe_out = False
            if self._state != "closed":
                self._transition("closed")

    def record_failure(self):
        with self._lock:
            self._probe_out = False
            if self._state == "half_open":
                self._denied = 0
                self.trips += 1
                _counters.incr("resilience.breaker_trips")
                self._transition("open")
                return
            self.consecutive_failures += 1
            if self._state == "closed" \
                    and self.consecutive_failures >= self.failure_threshold:
                self._denied = 0
                self.trips += 1
                _counters.incr("resilience.breaker_trips")
                self._transition("open")

    def snapshot(self):
        with self._lock:
            return {"state": self._state, "trips": self.trips,
                    "consecutive_failures": self.consecutive_failures,
                    "cooldown_remaining": (
                        max(0, self.cooldown_calls - self._denied)
                        if self._state == "open" else 0)}
