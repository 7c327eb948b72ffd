"""Resilience-private counters, mirrored onto the profiler bus (the
port's own copy of ``mxnet_tpu/resilience/counters.py``).

The robustness counters (injected faults so far in the port) must survive
``profiler.core.reset()`` — telemetry housekeeping between profiling
windows must not erase the record of a run that churned through
failures. So the source of truth lives here, and every
increment is *mirrored* to the profiler counter bus so the values still
show up in ``dumps_table()`` and chrome traces.
"""
from __future__ import annotations

import collections
import threading

from ..profiler import core as _prof
from ..profiler import recorder as _recorder

_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()


def incr(name, delta=1):
    with _lock:
        _counts[name] += delta
        value = _counts[name]
    _prof.incr_counter(name, delta, cat="resilience")
    # every resilience bump is flight-recorder-worthy: the ring of recent
    # retries/degradations/trips is what a crash dump reads back
    _recorder.note("counter", name, {"value": value})


def get(name, default=0):
    with _lock:
        return _counts.get(name, default)


def snapshot():
    """Consistent copy of every resilience counter."""
    with _lock:
        return dict(_counts)


def reset():
    """Zero the resilience counters (tests; NOT called by profiler.reset)."""
    with _lock:
        _counts.clear()


def should_warn(n) -> bool:
    """The resilience layer's shared warning rate-limit: warn on the 1st
    and 10th occurrence, then every 100th — loud enough that the first
    few incidents surface, quiet enough that a degraded steady state
    doesn't emit one warning per step. One predicate, every site
    (degradations, watchdog orphans, quarantines, stragglers)."""
    return n in (1, 10) or n % 100 == 0
