"""In-process telemetry event bus: scoped ranges, counters, chrome trace
(the port's own copy of ``mxnet_tpu/profiler/core.py``, host-only).

Instrumented call sites append complete ('X') events and counter ('C')
events here, and every duration also lands in an aggregate
``name -> [calls, total_s]`` table; :func:`dump` writes the events as
chrome://tracing JSON.

Hot-path contract: instrumented modules guard each hook on the
module-level ``ENABLED`` bool below — one attribute load and a branch
when the bus is stopped. :func:`start` / :func:`stop` flip it.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

# -- hot flags (read by instrumented modules; written by the facade) --------
ENABLED = False      # event bus recording is on (start())

_MAX_EVENTS = 2_000_000  # hard cap; beyond it events are counted as dropped

_lock = threading.Lock()             # guards events, aggregates and counters
_events: list = []                   # chrome trace event dicts
_dropped = 0
_epoch_ns = time.perf_counter_ns()   # ts origin for the whole process
_agg = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, total_s]
_counters: dict = {}                 # counter name -> last value
_thread_names: dict = {}             # tid -> human name ('M' metadata events)


def begin() -> int:
    """Timestamp for a range about to be recorded (perf_counter_ns)."""
    return time.perf_counter_ns()


def _ts_us(ns: int) -> float:
    return (ns - _epoch_ns) / 1e3


def start():
    global ENABLED
    ENABLED = True


def stop():
    global ENABLED
    ENABLED = False


def is_running() -> bool:
    return ENABLED


def reset():
    """Drop all recorded events, aggregates and counters."""
    global _dropped
    with _lock:
        _events.clear()
        _agg.clear()
        _counters.clear()
        _dropped = 0


def register_thread_name(name=None, tid=None):
    """Name the calling thread (or ``tid``) in dumped traces via a chrome
    'M' ``thread_name`` metadata event. Long-lived worker threads (batcher
    flusher, prefetch worker) call this once at startup; registration is
    kept across ``reset()`` so a later dump still labels them."""
    if tid is None:
        tid = threading.get_ident() & 0xFFFFFFFF
    if name is None:
        name = threading.current_thread().name
    with _lock:
        _thread_names[int(tid)] = str(name)


def append_event(ev):
    """Append a pre-built chrome event dict (trace/flow emitters). Honors
    the same ``ENABLED`` gate and event cap as the record_* helpers."""
    global _dropped
    if not ENABLED:
        return False
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return False
        _events.append(ev)
    return True


def record_duration(name, cat, t0_ns, t1_ns=None, args=None):
    """One completed range: aggregates always, a chrome 'X' event when the
    bus is running (so the aggregate table keeps filling with the bus
    stopped)."""
    global _dropped
    if t1_ns is None:
        t1_ns = time.perf_counter_ns()
    dur_s = (t1_ns - t0_ns) / 1e9
    enabled = ENABLED
    with _lock:
        row = _agg[name]
        row[0] += 1
        row[1] += dur_s
        if not enabled:
            return
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return
        ev = {"ph": "X", "name": name, "cat": cat or "host",
              "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFFFFFF,
              "ts": round(_ts_us(t0_ns), 3),
              "dur": round((t1_ns - t0_ns) / 1e3, 3)}
        if args:
            ev["args"] = args
        _events.append(ev)


def record_instant(name, cat="host", args=None):
    """A point-in-time marker (chrome 'i' event)."""
    global _dropped
    if not ENABLED:
        return
    ev = {"ph": "i", "s": "t", "name": name, "cat": cat,
          "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFFFFFF,
          "ts": round(_ts_us(time.perf_counter_ns()), 3)}
    if args:
        ev["args"] = args
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return
        _events.append(ev)


def _counter_event(name, value, cat):
    """Append the chrome 'C' gauge event. Caller holds ``_lock``."""
    global _dropped
    if len(_events) >= _MAX_EVENTS:
        _dropped += 1
        return
    _events.append({"ph": "C", "name": name, "cat": cat,
                    "pid": os.getpid(),
                    "ts": round(_ts_us(time.perf_counter_ns()), 3),
                    "args": {"value": value}})


def set_counter(name, value, cat="counters"):
    """Record a gauge value (chrome 'C' event when running)."""
    with _lock:
        _counters[name] = value
        if ENABLED:
            _counter_event(name, value, cat)


def incr_counter(name, delta=1, cat="counters"):
    """Atomic counter bump: the read-modify-write happens under ``_lock``
    so concurrent increments from batcher/flusher/engine threads never
    lose counts."""
    with _lock:
        value = _counters.get(name, 0) + delta
        _counters[name] = value
        if ENABLED:
            _counter_event(name, value, cat)
    return value


def get_counter(name, default=0):
    return _counters.get(name, default)


def counters_snapshot():
    """Consistent copy of every counter gauge."""
    with _lock:
        return dict(_counters)


def aggregate_stats():
    """``{name: {"calls", "total_s", "avg_s"}}`` over all recorded ranges."""
    with _lock:
        return {
            name: {"calls": cnt, "total_s": tot,
                   "avg_s": tot / cnt if cnt else 0.0}
            for name, (cnt, tot) in _agg.items()
        }


def dumps_table(reset_after=False):
    """Formatted aggregate table (``MXAggregateProfileStatsPrint`` analog):
    ranges by total time, then the latest counter gauges."""
    lines = [f"{'Name':<44}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"]
    with _lock:
        rows = sorted(_agg.items(), key=lambda kv: -kv[1][1])
    for name, (cnt, total) in rows:
        lines.append(f"{name:<44}{cnt:>8}{total * 1e3:>12.3f}"
                     f"{total / max(cnt, 1) * 1e3:>12.3f}")
    if _counters:
        lines.append("")
        lines.append(f"{'Counter':<44}{'Value':>12}")
        for name in sorted(_counters):
            lines.append(f"{name:<44}{_counters[name]:>12}")
    if reset_after:
        # aggregate STATS only (the reference dumps(reset) contract):
        # the chrome-trace events and counter gauges survive for dump()
        with _lock:
            _agg.clear()
    return "\n".join(lines)


def snapshot_events():
    """Copy of the recorded chrome events (tests / tooling)."""
    with _lock:
        return list(_events)


def _meta_events():
    """Chrome 'M' metadata: process name plus a ``thread_name`` row for
    every registered worker thread and every currently-live thread, so
    Perfetto lanes read "mxtpu-serve-batcher[x]" instead of bare tids."""
    pid = os.getpid()
    names = dict(_thread_names)
    for t in threading.enumerate():
        if t.ident is not None:
            names.setdefault(t.ident & 0xFFFFFFFF, t.name)
    meta = [{"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": "mxnet_tpu_torch host"}}]
    for tid in sorted(names):
        meta.append({"ph": "M", "pid": pid, "tid": tid,
                     "name": "thread_name", "args": {"name": names[tid]}})
    return meta


def dump(path):
    """Write the chrome://tracing JSON (reference ``dump()`` contract:
    load the file in chrome://tracing or Perfetto). Returns ``path``.
    The event-list copy happens under ``_lock`` so a dump racing live
    appends can't serialize a half-written list."""
    with _lock:
        events = list(_events)
        dropped = _dropped
    doc = {"traceEvents": _meta_events() + events, "displayTimeUnit": "ms"}
    if dropped:
        doc["mxnet_tpu_torch_dropped_events"] = dropped
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
