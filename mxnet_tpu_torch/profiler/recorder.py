"""Always-on flight recorder: a cheap bounded ring of the most recent
notable events (faults, sheds, rejects, deadline expiries, breaker
transitions, counter bumps worth keeping), dumped to a timestamped JSON
file at the escalation points — circuit-breaker open, watchdog timeout,
SLO burn — so the moments before an incident are on disk even when
nobody was profiling (the port's own copy of
``mxnet_tpu/profiler/recorder.py``).

Unlike the profiler bus this runs regardless of ``core.ENABLED``: the
interesting traces are exactly the ones nobody started. With
``MXNET_FLIGHT_RECORDER=0`` every :func:`note` is one module-bool check;
enabled, it is a timestamp plus a locked ``deque.append`` into a
``MXNET_FLIGHT_RECORDER_SIZE`` ring.

Dump files (``flightrec-<utcstamp>-<reason>.json`` under
``MXNET_FLIGHT_RECORDER_DIR``, default the system tempdir) carry the
ring, a profiler-counter snapshot, the ``resilience.*`` counters and the
escalation's own context. Automatic dumps are capped per process
(``MXNET_FLIGHT_RECORDER_MAX_DUMPS``) and rate-limited to one per reason
per second.
"""
from __future__ import annotations

import collections
import datetime
import json
import os
import tempfile
import threading
import time

from .. import config as _cfg
from . import core as _core

ENABLED = bool(_cfg.get("MXNET_FLIGHT_RECORDER"))

_lock = threading.Lock()
_ring: collections.deque = collections.deque(
    maxlen=max(1, int(_cfg.get("MXNET_FLIGHT_RECORDER_SIZE"))))
_seq = 0
_dumps = 0
_last_dump_path = None
_last_dump_by_reason: dict = {}  # reason -> monotonic s of last dump


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def reset():
    """Clear the ring and the dump accounting (tests)."""
    global _seq, _dumps, _last_dump_path
    with _lock:
        _ring.clear()
        _seq = 0
        _dumps = 0
        _last_dump_path = None
        _last_dump_by_reason.clear()


def note(kind, name, args=None):
    """Append one ring entry. ``kind`` is the event class (``fault``,
    ``shed``, ``breaker``, ``warn``, ``counter``, ``escalation``...),
    ``name`` the specific site. Never raises."""
    global _seq
    if not ENABLED:
        return
    entry = {"t": time.time(), "thread": threading.current_thread().name,
             "kind": kind, "name": str(name)}
    if args:
        entry["args"] = args
    with _lock:
        _seq += 1
        entry["seq"] = _seq
        _ring.append(entry)


def snapshot():
    """Copy of the ring, oldest first."""
    with _lock:
        return list(_ring)



def last_dump_path():
    return _last_dump_path


def dump_count():
    return _dumps


def dump(reason, args=None, path=None, force=False):
    """Write the recorder state to JSON; returns the path, or ``None``
    when disabled / capped / rate-limited. Called from escalation hooks
    inside ``except`` blocks, so it must never raise — an I/O failure is
    swallowed and noted in the ring."""
    global _dumps, _last_dump_path
    if not ENABLED and not force:
        return None
    reason = str(reason)
    now = time.monotonic()
    with _lock:
        if path is None:
            if _dumps >= int(_cfg.get("MXNET_FLIGHT_RECORDER_MAX_DUMPS")):
                return None
            last = _last_dump_by_reason.get(reason)
            if last is not None and now - last < 1.0 and not force:
                return None
        _last_dump_by_reason[reason] = now
        ring = list(_ring)
    doc = {
        "reason": reason,
        "args": args or {},
        "pid": os.getpid(),
        "utc": datetime.datetime.now(datetime.timezone.utc)
        .replace(tzinfo=None).isoformat() + "Z",
        "ring": ring,
        "counters": _core.counters_snapshot(),
        "dropped_profiler_events": _core._dropped,
    }
    from ..resilience import counters as _rescnt

    doc["resilience_counters"] = _rescnt.snapshot()
    if path is None:
        d = _cfg.get("MXNET_FLIGHT_RECORDER_DIR") or tempfile.gettempdir()
        stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%S.%f")
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in reason)[:48]
        path = os.path.join(d, f"flightrec-{stamp}-{safe}.json")
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
    except OSError as e:
        note("warn", "recorder.dump_failed", {"error": str(e)})
        return None
    with _lock:
        _dumps += 1
        _last_dump_path = path
    note("dump", reason, {"path": path})
    return path
