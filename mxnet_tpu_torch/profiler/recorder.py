"""Always-on flight recorder: a cheap bounded ring of the most recent
notable events (faults, sheds, rejects, deadline expiries, counter bumps
worth keeping); the port's own copy of ``mxnet_tpu/profiler/recorder.py``.

Unlike the profiler bus this runs regardless of ``core.ENABLED``: the
interesting traces are exactly the ones nobody started. With
``MXNET_FLIGHT_RECORDER=0`` every :func:`note` is one module-bool check;
enabled, it is a timestamp plus a locked ``deque.append`` into a
``MXNET_FLIGHT_RECORDER_SIZE`` ring.

The reference's ``dump()`` to a JSON file is not ported yet: it arrives
with its first caller (the session's circuit breaker or watchdog).
Until then the ring is read through :func:`snapshot`.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import config as _cfg

ENABLED = bool(_cfg.get("MXNET_FLIGHT_RECORDER"))

_lock = threading.Lock()
_ring: collections.deque = collections.deque(
    maxlen=max(1, int(_cfg.get("MXNET_FLIGHT_RECORDER_SIZE"))))
_seq = 0


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def reset():
    """Clear the ring (tests)."""
    global _seq
    with _lock:
        _ring.clear()
        _seq = 0


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

