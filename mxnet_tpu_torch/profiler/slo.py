"""Declarative serving SLOs with multi-window error-budget burn rates (the
port's own copy of ``mxnet_tpu/profiler/slo.py``, host-only).

An :class:`SLO` states an objective over one of the serving metric
families — inter-token latency p99, TTFT p99, goodput, error rate — as
``SLO(metric, target, window)``: "99% of ITL samples land under
``target`` ms over any ``window`` seconds". An :class:`SLOMonitor`
attaches to a :class:`~..serve.metrics.ServeMetrics` accumulator (one
``is None`` branch per observation when absent — the hot-path contract)
and evaluates every objective Google-SRE style over TWO windows:

* **burn rate** = (bad-event fraction in window) / (error budget),
  where the budget is ``1 - ratio`` (e.g. 0.01 for a p99 objective);
* an objective **burns** only when BOTH the fast window (default
  ``window / 12``, the 1h/5m shape scaled down) and the slow window
  exceed the threshold (default ``MXNET_SLO_BURN_THRESHOLD`` = 14.4,
  the classic fast-page rate) with at least ``MXNET_SLO_MIN_EVENTS``
  fast-window events — a sparse healthy run can't false-alarm.

Escalation rides the flight recorder: the ok->burning edge dumps
reason ``slo_burn`` naming the violated objective (the recorder's own
per-reason rate limit and ``MXNET_FLIGHT_RECORDER_MAX_DUMPS`` cap bound
a storm to ONE dump). Gauges ``slo.burn_rate(...)`` /
``slo.budget_remaining(...)`` land on the profiler bus and the full
monitor state merges into ``export.snapshot()`` as ``slo.<name>.*``.
A burning monitor turns the ``/healthz`` surface **degraded, not
dead**: ``InferenceSession.health()`` carries the violation but
``ready()`` stays True — an SLO burn is a page, not a kill switch.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

from . import core as _core
from . import recorder as _recorder

# live monitors, for export.snapshot() pull-discovery
_instances: "weakref.WeakSet" = weakref.WeakSet()

# metric family -> (feed kind, default good-ratio). Latency families
# judge each sample against the ms target at the implied quantile;
# ratio families judge completions, with the target AS the ratio.
_FAMILIES = {
    "itl_p99_ms": ("itl_ms", 0.99),
    "ttft_p99_ms": ("ttft_ms", 0.99),
    "goodput": ("completion", None),      # target = min good fraction
    "error_rate": ("completion", None),   # target = max error fraction
}


class SLO:
    """One declarative objective: ``SLO("itl_p99_ms", 50.0, 60.0)``
    reads "ITL p99 <= 50 ms over any 60 s window".

    Parameters
    ----------
    metric : one of ``itl_p99_ms`` / ``ttft_p99_ms`` / ``goodput`` /
        ``error_rate``.
    target : ms bound for the latency families; good-completion
        fraction for ``goodput`` (e.g. 0.99); max error fraction for
        ``error_rate`` (e.g. 0.01).
    window : slow evaluation window, seconds (``None`` =
        ``MXNET_SLO_WINDOW_S``).
    fast_window : fast window, seconds (default ``window / 12`` — the
        SRE 1h/5m ratio, scaled to whatever ``window`` is).
    threshold : burn-rate alert threshold over BOTH windows (default
        ``MXNET_SLO_BURN_THRESHOLD``).
    """

    __slots__ = ("metric", "target", "window", "fast_window", "threshold",
                 "ratio", "kind")

    def __init__(self, metric, target, window=None, fast_window=None,
                 threshold=None):
        from .. import config

        if metric not in _FAMILIES:
            from ..base import MXNetError

            raise MXNetError(
                f"unknown SLO metric {metric!r} (want one of "
                f"{sorted(_FAMILIES)})")
        self.metric = metric
        self.target = float(target)
        self.kind, ratio = _FAMILIES[metric]
        if window is None:
            window = float(config.get("MXNET_SLO_WINDOW_S"))
        self.window = float(window)
        self.fast_window = (float(fast_window) if fast_window is not None
                            else self.window / 12.0)
        if threshold is None:
            threshold = float(config.get("MXNET_SLO_BURN_THRESHOLD"))
        self.threshold = float(threshold)
        # error budget: the allowed bad-event fraction
        if ratio is not None:
            self.ratio = ratio                      # latency p99 family
        elif metric == "goodput":
            self.ratio = self.target                # target IS the ratio
        else:                                       # error_rate
            self.ratio = 1.0 - self.target
        self.ratio = min(max(self.ratio, 0.0), 1.0 - 1e-9)

    @property
    def budget(self):
        return 1.0 - self.ratio

    def good(self, value=None, ok=True, deadline_ok=True):
        """Is one observed event within this objective?"""
        if self.kind in ("itl_ms", "ttft_ms"):
            return float(value) <= self.target
        if self.metric == "goodput":
            return bool(ok) and bool(deadline_ok)
        return bool(ok)  # error_rate: any non-error completion is good

    def describe(self):
        return {"metric": self.metric, "target": self.target,
                "window_s": self.window, "fast_window_s": self.fast_window,
                "threshold": self.threshold, "budget": self.budget}


class SLOMonitor:
    """Multi-window burn-rate evaluator over a set of objectives.

    Feed it through :meth:`attach` (the ``ServeMetrics`` observation
    hooks call :meth:`observe`) or directly with explicit timestamps
    (the table-driven tests do). Evaluation is passive and amortized:
    at most once per ``MXNET_SLO_EVAL_INTERVAL_S`` on the observing
    thread — no extra threads, nothing to shut down.
    """

    def __init__(self, name, objectives, eval_interval=None,
                 min_events=None):
        from .. import config

        self.name = name
        self.objectives = list(objectives)
        if eval_interval is None:
            eval_interval = float(config.get("MXNET_SLO_EVAL_INTERVAL_S"))
        self._eval_interval = float(eval_interval)
        if min_events is None:
            min_events = int(config.get("MXNET_SLO_MIN_EVENTS"))
        self._min_events = int(min_events)
        self._lock = threading.Lock()
        # one timestamped (ts, good) ring per objective
        self._events = [collections.deque(maxlen=4096)
                        for _ in self.objectives]
        self._last_eval = 0.0
        self._state = "ok"
        self._violations = {}   # metric -> last evaluate() row
        self._last_eval_rows = []
        self.burns = 0          # cumulative ok->burning edges
        _instances.add(self)

    # -- feeding -------------------------------------------------------------
    def attach(self, serve_metrics):
        """Wire this monitor into a ``ServeMetrics`` accumulator's
        observation hooks; returns self for chaining."""
        serve_metrics.slo = self
        return self

    def observe(self, kind, value=None, ok=True, deadline_ok=True,
                ts=None):
        """One observed event of ``kind`` (``itl_ms`` / ``ttft_ms`` /
        ``completion``); routed to every objective of that family."""
        now = ts if ts is not None else time.monotonic()
        hit = False
        with self._lock:
            for i, obj in enumerate(self.objectives):
                if obj.kind != kind:
                    continue
                self._events[i].append(
                    (now, obj.good(value=value, ok=ok,
                                   deadline_ok=deadline_ok)))
                hit = True
        if hit and ts is None \
                and now - self._last_eval >= self._eval_interval:
            self.evaluate(now)

    # -- evaluation ----------------------------------------------------------
    def _window_rate(self, events, now, window):
        """(bad_fraction, n_events) over ``[now - window, now]``."""
        bad = n = 0
        for ts, good in reversed(events):
            if now - ts > window:
                break
            n += 1
            if not good:
                bad += 1
        return (bad / n if n else 0.0), n

    def evaluate(self, now=None):
        """Evaluate every objective's fast+slow burn rates; fires the
        ``slo_burn`` flight-recorder escalation on an ok->burning edge
        and refreshes the ``slo.*`` gauges. Returns the per-objective
        rows."""
        if now is None:
            now = time.monotonic()
        rows = []
        burning_metrics = []
        with self._lock:
            self._last_eval = now
            snap = [list(ev) for ev in self._events]
        for obj, events in zip(self.objectives, snap):
            bad_fast, n_fast = self._window_rate(events, now,
                                                 obj.fast_window)
            bad_slow, n_slow = self._window_rate(events, now, obj.window)
            burn_fast = bad_fast / obj.budget
            burn_slow = bad_slow / obj.budget
            # budget left in the slow window: 1 = untouched, 0 = spent
            budget_remaining = max(0.0, 1.0 - burn_slow)
            burning = (n_fast >= self._min_events
                       and burn_fast >= obj.threshold
                       and burn_slow >= obj.threshold)
            row = {"metric": obj.metric, "target": obj.target,
                   "burn_rate_fast": round(burn_fast, 4),
                   "burn_rate_slow": round(burn_slow, 4),
                   "budget_remaining": round(budget_remaining, 4),
                   "events_fast": n_fast, "events_slow": n_slow,
                   "threshold": obj.threshold, "burning": burning}
            rows.append(row)
            if burning:
                burning_metrics.append(row)
            if _core.ENABLED:
                tag = f"{self.name}:{obj.metric}"
                _core.set_counter(f"slo.burn_rate({tag})",
                                  round(burn_fast, 4), cat="slo")
                _core.set_counter(f"slo.budget_remaining({tag})",
                                  round(budget_remaining, 4), cat="slo")
        with self._lock:
            was = self._state
            self._state = "degraded" if burning_metrics else "ok"
            self._violations = {r["metric"]: r for r in burning_metrics}
            self._last_eval_rows = rows
            edge = burning_metrics and was == "ok"
            if edge:
                self.burns += 1
        if edge:
            # the recorder's per-reason rate limit + dump cap bound a
            # sustained storm to one dump; name the violated objective
            worst = max(burning_metrics,
                        key=lambda r: r["burn_rate_fast"])
            _recorder.note("escalation", f"slo.burn({self.name})",
                           {"metric": worst["metric"]})
            _recorder.dump("slo_burn", {
                "monitor": self.name,
                "objective": worst["metric"],
                "target": worst["target"],
                "burn_rate_fast": worst["burn_rate_fast"],
                "burn_rate_slow": worst["burn_rate_slow"],
                "violations": burning_metrics,
            })
        return rows

    # -- readout -------------------------------------------------------------
    @property
    def state(self):
        return self._state

    def health(self):
        """The ``/healthz`` fragment: degraded-not-dead."""
        with self._lock:
            return {"state": self._state,
                    "violations": sorted(self._violations),
                    "burns": self.burns}

    def snapshot(self):
        with self._lock:
            rows = list(self._last_eval_rows)
            state = self._state
            burns = self.burns
        out = {"state": state, "degraded": int(state == "degraded"),
               "burns": burns}
        for r in rows:
            m = r["metric"]
            out[f"{m}.burn_rate_fast"] = r["burn_rate_fast"]
            out[f"{m}.burn_rate_slow"] = r["burn_rate_slow"]
            out[f"{m}.budget_remaining"] = r["budget_remaining"]
            out[f"{m}.burning"] = int(r["burning"])
        return out


def all_snapshots():
    """``{monitor_name: snapshot()}`` over every live monitor."""
    return {m.name: m.snapshot() for m in list(_instances)}
