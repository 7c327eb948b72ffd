"""`Replica`: one in-process serving unit a fleet :class:`Router` can
dispatch to, probe, drain, swap, and kill (the port's counterpart of
``mxnet_tpu/serve/replica.py``).

A replica is the smallest thing the fleet layer reasons about: a
``runner`` callable behind its own :class:`~.batcher.DynamicBatcher`
(so each replica has an independent admission queue, flusher thread,
and metrics window), optionally attached to the
:class:`~.engine.InferenceSession` that executes its batches (the
session contributes warm/breaker/drain state to the replica's probes
and its ``swap()`` to the fleet rollout path).

The ``replica:dispatch`` fault site fires inside :meth:`submit`, before
the request enters the batcher, with ``info={"replica": index}`` — a
``die`` there is a serving-replica death at dispatch time (the Router
catches the :class:`~..resilience.faults.SimulatedWorkerDeath`, marks
the replica dead, and fails the request over to a survivor), while
``transient``/``fatal`` model a flaky dispatch RPC. A ``die`` injected
at an *execution* site (``serve:execute``, ``serve:decode``) instead
kills the batcher's flusher thread mid-batch — that replica stops
settling work, which is exactly what :meth:`alive` detects and the
Router's supervisor sweeps up.
"""
from __future__ import annotations

import time

from ..profiler import export as _export
from ..resilience import faults as _faults
from .batcher import DynamicBatcher
from .engine import ServeError

__all__ = ["Replica"]


class Replica:
    """One serving replica: a private batcher + flusher over ``runner``.

    Parameters
    ----------
    runner : callable(list) -> list
        Executes one assembled batch (the :class:`DynamicBatcher`
        contract: one result per payload, an Exception instance in a
        slot fails that request alone).
    index : int
        Fleet-unique replica id; lands in fault-site info, metrics
        names, and the Router's straggler/health bookkeeping.
    session : InferenceSession, optional
        The session executing this replica's batches. Wires
        ``ready()``/``health()`` depth and enables :meth:`swap`.
    max_batch_size, timeout_ms, max_queue :
        Per-replica :class:`DynamicBatcher` overrides.
    device : the device ``runner`` computes on (default: the session's,
        if one is given). The replica's flusher thread makes it current
        and runs the runner under ``torch.inference_mode()``.
    """

    def __init__(self, runner, index=0, name=None, session=None,
                 max_batch_size=None, timeout_ms=None, max_queue=None,
                 device=None):
        self.index = int(index)
        self.name = name or f"replica{self.index}"
        self.session = session
        if device is None and session is not None:
            device = session.device
        self.batcher = DynamicBatcher(
            runner, max_batch_size=max_batch_size, timeout_ms=timeout_ms,
            max_queue=max_queue, name=self.name, device=device)
        self.metrics = self.batcher.metrics
        self._killed = False
        self.t_started = time.monotonic()

    # -- dispatch -----------------------------------------------------------
    def submit(self, payload, priority="interactive", deadline_ms=None,
               key=None):
        """Dispatch one request into this replica's queue; returns the
        batcher future. The ``replica:dispatch`` fault site fires first
        (an injected ``die`` here propagates
        :class:`SimulatedWorkerDeath` to the caller — replica death at
        dispatch time, the Router's failover trigger)."""
        _faults.fault_point("replica:dispatch",
                            {"replica": self.index, "name": self.name,
                             "priority": priority})
        return self.batcher.submit(payload, priority=priority,
                                   deadline_ms=deadline_ms, key=key)

    # -- probes -------------------------------------------------------------
    def alive(self):
        """Liveness: not killed AND the flusher thread is still running.
        A ``die`` fault inside the runner kills the flusher (it is a
        BaseException — deliberately not caught by the batcher's
        per-batch isolation), so a dead flusher IS a dead replica."""
        if self._killed:
            return False
        t = self.batcher._thread
        return t is not None and t.is_alive()

    def ready(self):
        """Readiness: alive, admitting (not draining/closed), and — when
        a session is attached — the session's own readiness (warm lattice,
        breaker not open). False is the Router's route-around cue."""
        if not self.alive():
            return False
        with self.batcher._cond:
            if self.batcher._closed or self.batcher._draining:
                return False
        if self.session is not None:
            return bool(self.session.ready())
        return True

    def load(self):
        """Dispatch-cost gauge: queued + in-flight requests."""
        with self.batcher._cond:
            return len(self.batcher._queue) + len(self.batcher._inflight)

    def p99_ms(self):
        return self.metrics.latency_percentiles()["p99_ms"]

    def health(self):
        """Probe payload for the fleet ``/healthz`` aggregation."""
        out = {
            "alive": self.alive(),
            "ready": self.ready(),
            "killed": self._killed,
            "load": self.load(),
            "p99_ms": self.p99_ms(),
        }
        if self.session is not None:
            out["session"] = self.session.health()
        return out

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout=30.0):
        """Graceful quiesce: stop admission, wait for queue + in-flight
        to settle. Returns True once quiet, False on timeout."""
        return self.batcher.drain(timeout)

    def resume(self):
        self.batcher.resume()

    def swap(self, new_block, example=None, timeout=30.0):
        """Zero-downtime model swap for THIS replica: drain the batcher
        (no new batches dispatch), hot-swap the session (warm = weights
        copied in place, no new signature), resume. Returns the swap
        mode."""
        if self.session is None:
            raise ServeError(
                f"replica {self.name!r} has no session to swap")
        if not self.batcher.drain(timeout):
            self.batcher.resume()
            raise ServeError(
                f"replica {self.name!r}: swap aborted — batcher did not "
                f"quiesce within {timeout}s")
        try:
            mode = self.session.swap(new_block, example=example,
                                     timeout=timeout)
        finally:
            self.batcher.resume()
        return mode

    def kill(self, timeout=2.0):
        """Hard-stop this replica. The batcher close fails anything
        still queued or wedged in-flight with a structural 503 — by the
        time the Router calls this it has already fenced those requests'
        generations and requeued them to survivors, so the 503s settle
        into dropped duplicates, not client-visible errors. Idempotent."""
        if self._killed:
            return
        self._killed = True
        if self.session is not None:
            # the fleet Router answers /healthz for the fleet; a dead
            # replica's session must not keep 503ing the process probe
            _export.unregister_health_provider(self.session)
        self.batcher.close(timeout=timeout)

    def stats(self):
        out = self.batcher.stats()
        out["alive"] = self.alive()
        out["ready"] = self.ready()
        out["load"] = self.load()
        if self.session is not None:
            out["breaker"] = self.session.breaker.snapshot()
        return out
