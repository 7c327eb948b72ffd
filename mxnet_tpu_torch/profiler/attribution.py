"""Decode critical-path attribution: WHERE each decode iteration's wall
time goes (the port's own copy of ``mxnet_tpu/profiler/attribution.py``).

Every decode host visit's wall time is split into four exclusive phases:

* **host**     — python bookkeeping inside the step (sampling, token
  accounting) plus, at the scheduler level, the admit/retire work between
  device calls (the *schedule* bucket);
* **dispatch** — issuing the step (eager launches, or a CUDA-graph
  replay, which returns before the card finishes);
* **device**   — the delta around the blocking read of the step's
  sampled ids or token block;
* **wait**     — stalls *outside* that sanctioned blocking read, from
  :func:`note_wait`. The JAX package feeds it from its dependency
  engine's wait hooks; the port has no such engine, so nothing feeds it
  yet and the phase reads 0.

The four phases partition the ``serve::decode_step`` span wall, roll up
into per-engine :class:`Ledger` gauges (``host_overhead_fraction``,
``device_ms_per_token``, published through ``ServeMetrics``), and compose
into per-request critical-path reports keyed by trace ids
(:func:`report`).

Hot-path contract: everything is gated on the module-level ``ENABLED``
bool (``MXNET_ATTRIBUTION=1`` or :func:`enable`); a disabled ledger costs
one attribute load and a branch per site. Phase *scopes*
(:func:`phase_scope`) are independent of ``ENABLED``: the scheduler always
labels its thread's active phase (an attribute store).
"""
from __future__ import annotations

import collections
import threading
import weakref

from . import trace as _trace

ENABLED = False

_tls = threading.local()
_lock = threading.Lock()
# process-wide wait stall totals by phase (ns), from note_wait
_wait_ns_by_phase: "collections.Counter" = collections.Counter()
# live Ledgers, for export.snapshot() pull-discovery (weak: a retired
# engine's ledger is simply no longer exported)
_instances: "weakref.WeakSet" = weakref.WeakSet()

PHASES = ("decode", "prefill", "train", "input", "other")


def enable():
    """Turn the ledger on."""
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def reset():
    """Drop accumulated wait totals (tests)."""
    with _lock:
        _wait_ns_by_phase.clear()
    _tls.wait_ns = 0


# -- phase scopes ------------------------------------------------------------

class _PhaseCtx:
    __slots__ = ("_phase", "_prev")

    def __init__(self, phase):
        self._phase = phase

    def __enter__(self):
        self._prev = getattr(_tls, "phase", None)
        _tls.phase = self._phase
        return self

    def __exit__(self, *a):
        _tls.phase = self._prev
        return False


def phase_scope(phase):
    """Label the calling thread's active phase (``decode`` / ``prefill``
    / ``train`` / ``input`` / ``other``) for the ``with`` body. Engine
    wait stalls inside the scope are tagged with it."""
    return _PhaseCtx(phase)


def current_phase():
    """The calling thread's active phase ("other" when unlabeled)."""
    return getattr(_tls, "phase", None) or "other"


# -- wait capture ------------------------------------------------------------

def note_wait(dur_ns, phase=None):
    """Account one wait stall of ``dur_ns`` against the calling thread's
    running total and the per-phase process totals (while ``ENABLED``).
    The JAX package calls it from its dependency engine's wait hooks; the
    port has no dependency engine, so no port code calls it yet."""
    if not ENABLED:
        return
    dur_ns = int(dur_ns)
    _tls.wait_ns = getattr(_tls, "wait_ns", 0) + dur_ns
    p = phase or current_phase()
    with _lock:
        _wait_ns_by_phase[p] += dur_ns


def thread_wait_ns():
    """The calling thread's monotonically-increasing accumulated wait ns
    (never reset): instrumented loops snapshot it at window boundaries
    and difference the snapshots. Only :func:`note_wait` adds to it, and
    nothing in the port feeds that yet, so in the port's scheduler it
    stays 0 and the ledger's wait phase reads 0."""
    return getattr(_tls, "wait_ns", 0)


def wait_ms_by_phase():
    """``{phase: total_ms}`` of :func:`note_wait` stall time since import
    (or :func:`reset`)."""
    with _lock:
        return {k: v / 1e6 for k, v in _wait_ns_by_phase.items()}


# -- the per-engine ledger ---------------------------------------------------

class Ledger:
    """Rolling per-iteration phase ledger for one engine/generator.

    :meth:`observe_step` lands one decode iteration's four-way split
    (partitioning the ``serve::decode_step`` span wall) plus the live
    slot count; :meth:`observe_schedule` lands the host-schedule time
    *between* device calls (retire/admit bookkeeping, input-array
    assembly). Bounded window so a long-lived server's gauges track
    steady state, not its cold start.
    """

    __slots__ = ("name", "_lock", "_rows", "_sched_ms", "steps",
                 "__weakref__")

    def __init__(self, name, window=None):
        if window is None:
            from .. import config

            window = config.get("MXNET_ATTRIBUTION_WINDOW")
        self.name = name
        self._lock = threading.Lock()
        # (host_ms, dispatch_ms, device_ms, wait_ms, live, tokens)
        self._rows = collections.deque(maxlen=int(window))
        self._sched_ms = collections.deque(maxlen=int(window))
        self.steps = 0
        _instances.add(self)

    def observe_step(self, host_ms, dispatch_ms, device_ms, wait_ms,
                     live=1, tokens=None):
        """One decode host visit's exclusive four-phase split (ms), its
        live-slot count, and the tokens it produced. In the classic
        single-step loop one visit is one iteration and ``tokens`` can
        stay ``None`` (it defaults to ``live``: every live slot emits
        one token). A multi-step super-step passes ``tokens`` explicitly
        — host/dispatch/wait are real per-visit costs (paid once for the
        whole block), while device time covers N iterations, so
        ``device_ms_per_token`` must divide by tokens, not visits."""
        with self._lock:
            self._rows.append((float(host_ms), float(dispatch_ms),
                               float(device_ms), float(wait_ms),
                               int(live),
                               int(live if tokens is None else tokens)))
            self.steps += 1

    def observe_schedule(self, ms):
        """Host-schedule time between device calls (retire/admit, input
        assembly) for one scheduler iteration."""
        with self._lock:
            self._sched_ms.append(float(ms))

    def _totals(self):
        host = dispatch = device = wait = 0.0
        tokens = 0
        for h, di, de, w, live, tok in self._rows:
            host += h
            dispatch += di
            device += de
            wait += w
            tokens += tok
        return host, dispatch, device, wait, tokens, sum(self._sched_ms)

    def host_overhead_fraction(self):
        """Fraction of windowed iteration wall NOT spent in the blocking
        device window: (schedule + host + dispatch + wait) / total.
        0.0 with no samples; in [0, 1] by construction."""
        with self._lock:
            host, dispatch, device, wait, _, sched = self._totals()
        total = sched + host + dispatch + device + wait
        if total <= 0.0:
            return 0.0
        return (sched + host + dispatch + wait) / total

    def device_ms_per_token(self):
        """Windowed device-compute ms per emitted token (device phase
        normalized by live-slot occupancy — the number ITL p50 is judged
        against)."""
        with self._lock:
            _, _, device, _, tokens, _ = self._totals()
        return device / tokens if tokens else 0.0

    def snapshot(self):
        with self._lock:
            host, dispatch, device, wait, tokens, sched = self._totals()
            n = len(self._rows)
            steps = self.steps
        total = sched + host + dispatch + device + wait
        return {
            "steps": steps,
            "window": n,
            "host_ms": round(host, 3),
            "dispatch_ms": round(dispatch, 3),
            "device_ms": round(device, 3),
            "wait_ms": round(wait, 3),
            "schedule_ms": round(sched, 3),
            "tokens": tokens,
            "tokens_per_visit": tokens / n if n else 0.0,
            "host_overhead_fraction": (
                (sched + host + dispatch + wait) / total if total else 0.0),
            "device_ms_per_token": device / tokens if tokens else 0.0,
        }


# -- per-request critical path -----------------------------------------------

_LEDGER_KEYS = ("host_ms", "dispatch_ms", "device_ms", "wait_ms")


def all_snapshots():
    """``{ledger_name: snapshot()}`` over every live ledger (same-named
    ledgers merge last-writer-wins, like ``serve.metrics``)."""
    return {l.name: l.snapshot() for l in list(_instances)}


def _bucket(name):
    if "queue" in name:
        return "queue"
    if "prefill" in name:
        return "prefill"
    if "decode" in name:
        return "decode"
    if "settle" in name or "execute" in name or "session_run" in name:
        return "settle"
    return "other"


def report(trace_id):
    """Per-request critical-path attribution for one trace id:
    queue -> prefill chunks -> N decode super-steps -> settle, with the
    decode super-steps' four-phase ledger totals summed from the
    ``serve::decode_step`` span args. ``None`` if the trace is unknown
    or evicted."""
    s = _trace.summary(trace_id)
    if s is None:
        return None
    phase_ms = {"queue": 0.0, "prefill": 0.0, "decode": 0.0,
                "settle": 0.0, "other": 0.0}
    counts = {"prefill": 0, "decode": 0}
    ledger = dict.fromkeys(_LEDGER_KEYS, 0.0)
    ledger_steps = 0
    ledger_tokens = 0
    for span in s["spans"]:
        b = _bucket(span["name"])
        phase_ms[b] += span["dur_ms"]
        if b in counts:
            counts[b] += 1
        args = span.get("args")
        if span["name"] == "serve::decode_step" and args \
                and all(k in args for k in _LEDGER_KEYS):
            ledger_steps += 1
            # multi-step visits stamp the tokens their block settled;
            # classic single-step spans predate the arg and count 1
            ledger_tokens += int(args.get("tokens", 1))
            for k in _LEDGER_KEYS:
                ledger[k] += float(args[k])
    accounted = sum(phase_ms.values())
    total = s["total_ms"]
    return {
        "trace_id": s["trace_id"],
        "name": s["name"],
        "finished": s["finished"],
        "error": s["error"],
        "total_ms": total,
        "queue_ms": phase_ms["queue"],
        "prefill_ms": phase_ms["prefill"],
        "prefill_chunks": counts["prefill"],
        "decode_ms": phase_ms["decode"],
        "decode_steps": counts["decode"],
        "settle_ms": phase_ms["settle"],
        "other_ms": phase_ms["other"],
        "phase_ledger": {k: round(v, 3) for k, v in ledger.items()},
        "ledger_steps": ledger_steps,
        "ledger_tokens": ledger_tokens,
        "tokens_per_visit": (ledger_tokens / ledger_steps
                             if ledger_steps else 0.0),
        "coverage": accounted / total if total > 0 else 0.0,
    }
