"""Elastic serving support (the port's counterpart of the part of
``mxnet_tpu/resilience/elastic.py`` the serving stack imports): the
per-replica :class:`StragglerMonitor` behind the fleet Router's hedging.

The rest of the JAX module — mesh-loss recovery, the elastic training
handlers and batch processor, the desync audit — is training-side and
not ported.
"""
from __future__ import annotations

import warnings

from ..profiler import core as _prof
from . import counters as _counters

__all__ = ["StragglerMonitor"]


def _flag(name):
    from .. import config

    return config.get(name)


# the installed monitor (profiler.export reads its gauges)
_active_monitor = None


class StragglerMonitor:
    """Per-replica step-time / collective-arrival-lag tracking.

    ``observe_step_times([t0..tR-1])`` feeds one batch's per-replica
    forward+backward wall times (the elastic batch processor measures
    them); each replica's *lag* is its time minus the group median that
    step. ``observe(replica, lag_s)`` feeds a directly-known lag (the
    ``replica_delay`` fault at ``kvstore:allreduce`` reports its injected
    sleep here). Both update a per-replica EWMA; when a replica's EWMA
    lag exceeds ``threshold_ms`` (``MXNET_STRAGGLER_THRESHOLD_MS``; 0 =
    tracking only, never flags) it is flagged: the
    ``resilience.stragglers`` counter increments, a
    ``resilience::straggler`` instant lands on the profiler bus, and a
    rate-limited warning (1st/10th/every-100th) names the replica.

    Per-replica gauges (live on the profiler counter bus):
    ``resilience.replica_step_ms[r]`` and
    ``resilience.replica_lag_ms[r]``.
    """

    def __init__(self, threshold_ms=None, alpha=0.4):
        self.threshold_ms = float(
            threshold_ms if threshold_ms is not None
            else _flag("MXNET_STRAGGLER_THRESHOLD_MS"))
        self.alpha = float(alpha)
        self._lag_ewma = {}    # replica -> seconds
        self._step_ewma = {}   # replica -> seconds
        self.stats = {"flags": 0, "last_straggler": None,
                      "observations": 0}

    def install(self):
        """Publish this monitor as the process's active one (its gauges
        land in ``profiler.export.snapshot()`` under
        ``resilience.straggler.*``). The JAX package also pokes it into
        its collective call sites; the port has no such module."""
        global _active_monitor
        _active_monitor = self
        return self

    @staticmethod
    def uninstall():
        global _active_monitor
        _active_monitor = None

    def snapshot(self):
        return {"threshold_ms": self.threshold_ms,
                "lag_ms": {r: v * 1e3 for r, v in self._lag_ewma.items()},
                "step_ms": {r: v * 1e3
                            for r, v in self._step_ewma.items()},
                **self.stats}

    def flagged(self, replica):
        """Is ``replica``'s lag EWMA over the threshold *right now*? (the
        serving Router's hedge predicate — threshold 0 never flags)"""
        if not self.threshold_ms:
            return False
        return self._lag_ewma.get(replica, 0.0) * 1e3 > self.threshold_ms

    def clear(self, replica):
        """Forget ``replica``'s EWMAs (a replaced/restarted replica starts
        with a clean slate instead of inheriting its predecessor's lag)."""
        self._lag_ewma.pop(replica, None)
        self._step_ewma.pop(replica, None)

    def observe_step_times(self, times_s):
        """One batch's per-replica wall times; lag = time − group
        median."""
        if not times_s:
            return
        srt = sorted(times_s)
        median = srt[len(srt) // 2]
        for r, t in enumerate(times_s):
            prev = self._step_ewma.get(r)
            ew = t if prev is None else self.alpha * t \
                + (1 - self.alpha) * prev
            self._step_ewma[r] = ew
            _prof.set_counter(f"resilience.replica_step_ms[{r}]",
                              round(ew * 1e3, 3), cat="resilience")
            self.observe(r, max(0.0, t - median), site="step")

    def observe(self, replica, lag_s, site="collective"):
        self.stats["observations"] += 1
        prev = self._lag_ewma.get(replica)
        ew = lag_s if prev is None else self.alpha * lag_s \
            + (1 - self.alpha) * prev
        self._lag_ewma[replica] = ew
        _prof.set_counter(f"resilience.replica_lag_ms[{replica}]",
                          round(ew * 1e3, 3), cat="resilience")
        if self.threshold_ms and ew * 1e3 > self.threshold_ms:
            self._flag_straggler(replica, ew, site)

    def _flag_straggler(self, replica, ew_lag_s, site):
        self.stats["flags"] += 1
        self.stats["last_straggler"] = int(replica)
        _counters.incr("resilience.stragglers")
        n = _counters.get("resilience.stragglers")
        if _prof.ENABLED:
            _prof.record_instant("resilience::straggler", "resilience",
                                 args={"replica": int(replica),
                                       "lag_ms": round(ew_lag_s * 1e3, 3),
                                       "site": site})
        if _counters.should_warn(n):
            warnings.warn(
                f"straggler: replica {replica} collective-arrival lag "
                f"EWMA {ew_lag_s * 1e3:.1f}ms exceeds "
                f"MXNET_STRAGGLER_THRESHOLD_MS={self.threshold_ms:.0f} "
                f"at {site} ({n} flag(s) so far) — one slow chip paces "
                "every collective; check its host/HBM before it becomes "
                "a mesh loss", RuntimeWarning, stacklevel=4)
