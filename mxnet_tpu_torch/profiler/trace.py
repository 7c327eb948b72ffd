"""Request-scoped tracing: one logical request (a serving submit, a
training step) gets a :class:`Trace` whose spans are emitted as chrome
*async* events ('b'/'e' sharing the trace id) plus *flow* arrows
('s'/'f') at thread handoffs — so in Perfetto the request reads as one
connected lane across the batcher client thread, the flusher, and the
decode loop, no matter which tid did the work. (The port's own copy of
``mxnet_tpu/profiler/trace.py``.)

Propagation is explicit-or-ambient: producers that hold the ``Trace``
object call :func:`span_at` / :func:`flow_out` on it directly (the
batcher stores it on the pending entry), while nested callees that can't
see it (``InferenceSession.run`` under the batcher's runner, the
generator's decode step) use the thread-local *current trace* installed
by :func:`activate`.

Everything here is gated on the module-level ``ENABLED`` bool (set via
``MXNET_TRACE=1`` or :func:`enable`), mirroring the profiler hot-path
contract: a disabled tracer costs one attribute load and a branch per
site. Span *events* additionally require the profiler bus to be
recording (``core.ENABLED``) — the in-process summaries in the bounded
trace registry work either way.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time

from . import core as _core

ENABLED = False

_ids = itertools.count(1)
_flow_ids = itertools.count(1)
_lock = threading.Lock()
_registry: "collections.OrderedDict[int, Trace]" = collections.OrderedDict()
_max_traces = 1024
_tls = threading.local()


def enable(max_traces=None):
    global ENABLED, _max_traces
    if max_traces is not None:
        _max_traces = max(1, int(max_traces))
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def reset():
    """Drop every registered trace (tests)."""
    with _lock:
        _registry.clear()
    _tls.stack = []


class Trace:
    """One logical request: an id, a lane name, and its recorded spans."""

    __slots__ = ("trace_id", "name", "t0_ns", "t1_ns", "error", "finished",
                 "spans", "args", "_slock")

    def __init__(self, trace_id, name, args=None):
        self.trace_id = trace_id
        self.name = name
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = None
        self.error = None
        self.finished = False
        self.spans = []
        self.args = args
        self._slock = threading.Lock()

    # -- span / flow emission -----------------------------------------------
    def span_at(self, name, t0_ns, t1_ns, args=None):
        """Record a completed span retroactively from stored ns stamps
        (the batcher emits ``queue`` at dispatch time, ``execute`` at
        settle time). Thread-safe; callable from any thread."""
        tid = threading.get_ident() & 0xFFFFFFFF
        with self._slock:
            if not self.finished:
                self.spans.append({"name": name, "t0_ns": int(t0_ns),
                                   "t1_ns": int(t1_ns), "tid": tid,
                                   "args": args})
        if _core.ENABLED:
            pid = os.getpid()
            sid = str(self.trace_id)
            b = {"ph": "b", "cat": "trace", "name": name, "id": sid,
                 "pid": pid, "tid": tid,
                 "ts": round(_core._ts_us(t0_ns), 3)}
            if args:
                b["args"] = args
            _core.append_event(b)
            _core.append_event({"ph": "e", "cat": "trace", "name": name,
                                "id": sid, "pid": pid, "tid": tid,
                                "ts": round(_core._ts_us(t1_ns), 3)})

    def span(self, name, args=None):
        """Context manager recording one span around its body."""
        return _SpanCtx(self, name, args)

    def flow_out(self, name="handoff"):
        """Start a flow arrow at *this* thread/time; returns the flow id
        the receiving thread passes to :func:`flow_in`. Every issued id
        must eventually be closed (``flow_in``) so dumped traces carry no
        orphan arrows — close it on the shed/expired path too."""
        fid = next(_flow_ids)
        if _core.ENABLED:
            _core.append_event({
                "ph": "s", "cat": "trace.flow", "name": name,
                "id": str(fid), "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": round(_core._ts_us(time.perf_counter_ns()), 3)})
        return fid

    def flow_in(self, fid, name="handoff"):
        """Finish a flow arrow on the receiving thread."""
        if fid and _core.ENABLED:
            _core.append_event({
                "ph": "f", "bp": "e", "cat": "trace.flow", "name": name,
                "id": str(fid), "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": round(_core._ts_us(time.perf_counter_ns()), 3)})

    def finish(self, error=None):
        """Seal the trace (idempotent); later span_at calls are ignored."""
        with self._slock:
            if self.finished:
                return
            self.finished = True
            self.t1_ns = time.perf_counter_ns()
            if error is not None:
                self.error = str(error)

    def summary(self):
        """Per-trace readout: spans in record order plus per-name totals
        and the set of threads the request touched."""
        with self._slock:
            spans = list(self.spans)
            t1 = self.t1_ns
            err = self.error
            done = self.finished
        by_name = collections.defaultdict(lambda: [0, 0])
        tids = set()
        for s in spans:
            row = by_name[s["name"]]
            row[0] += 1
            row[1] += s["t1_ns"] - s["t0_ns"]
            tids.add(s["tid"])
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "finished": done,
            "error": err,
            "total_ms": (((t1 or time.perf_counter_ns()) - self.t0_ns)
                         / 1e6),
            "threads": len(tids),
            "spans": [{"name": s["name"],
                       "dur_ms": (s["t1_ns"] - s["t0_ns"]) / 1e6,
                       "tid": s["tid"], "args": s["args"]}
                      for s in spans],
            "by_name": {k: {"calls": v[0], "total_ms": v[1] / 1e6}
                        for k, v in by_name.items()},
        }


class _SpanCtx:
    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr, name, args):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        args = self._args
        if exc is not None:
            args = dict(args or ())
            args["error"] = type(exc).__name__
        self._tr.span_at(self._name, self._t0, time.perf_counter_ns(), args)
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _NullCtx()


# -- registry / ambient-trace API -------------------------------------------

def start_trace(name, args=None):
    """Create and register a new :class:`Trace`; ``None`` when tracing is
    off (every caller treats a ``None`` trace as "don't instrument")."""
    if not ENABLED:
        return None
    tr = Trace(next(_ids), name, args=args)
    with _lock:
        _registry[tr.trace_id] = tr
        while len(_registry) > _max_traces:
            _registry.popitem(last=False)
    return tr


def get(trace_id):
    with _lock:
        return _registry.get(trace_id)


def summary(trace_id):
    """In-process per-request span summary (``None`` if evicted/unknown)."""
    tr = get(trace_id)
    return tr.summary() if tr is not None else None


def summaries(limit=32):
    """Most recent ``limit`` trace summaries, newest last."""
    with _lock:
        traces = list(_registry.values())[-limit:]
    return [t.summary() for t in traces]


class _ActivateCtx:
    __slots__ = ("_tr",)

    def __init__(self, tr):
        self._tr = tr

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._tr)
        return self._tr

    def __exit__(self, *a):
        _tls.stack.pop()
        return False


def activate(tr):
    """Make ``tr`` the calling thread's ambient trace for the ``with``
    body (no-op for a ``None`` trace)."""
    return _ActivateCtx(tr) if tr is not None else _NULL


def current():
    """The calling thread's ambient trace, or ``None``."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def span(name, args=None):
    """Span on the ambient trace; no-op context when none is active."""
    tr = current()
    return tr.span(name, args) if tr is not None else _NULL
