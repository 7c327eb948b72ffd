"""Serving SLO metrics: latency percentiles, queue depth, batch occupancy,
tokens/s, TTFT, ITL, KV pages, slot occupancy and the prefix-cache gauges
(counterpart of ``mxnet_tpu/serve/metrics.py``, host-only).

One :class:`ServeMetrics` instance rides along with each serving component
(session, batcher, continuous engine — they can share one). Observations
land in bounded rings (``MXNET_SERVE_METRICS_WINDOW`` samples) so a
long-lived server's snapshot cost stays flat, and every observation also
emits a ``serve::*`` event through the profiler bus
(``mxnet_tpu_torch.profiler.core``) when it is recording. A
``profiler.slo.SLOMonitor`` attached with ``attach()`` sees every
completion, TTFT and ITL sample, and every live instance is exported
through ``profiler.export.snapshot()`` as ``serve.<name>.*``.
"""
from __future__ import annotations

import collections
import math
import threading
import weakref

from ..profiler import core as _prof
from ..profiler import recorder as _recorder

# live ServeMetrics instances, for the process-wide all_snapshots()
# aggregate (profiler.export pulls it); weak so the registry never pins
# a retired server's accumulator
_instances: "weakref.WeakSet" = weakref.WeakSet()


def all_snapshots():
    """``{instance_name: snapshot()}`` over every live ServeMetrics.
    Same-named instances merge last-writer-wins (deployments that share
    one accumulator across session and batcher see exactly one entry)."""
    return {m.name: m.snapshot() for m in list(_instances)}


def percentile(samples, pct):
    """Nearest-rank percentile of an unsorted sequence (0 < pct <= 100):
    the smallest sample such that at least ``pct`` percent of the window
    is <= it, i.e. rank ``ceil(pct/100 * n)`` (1-based). ``round()`` would
    banker's-round even-window ranks off by one (p50 of ``[1, 2]`` must
    be 1, not 2). Returns 0.0 on no samples — a dashboard-friendly zero,
    not a crash."""
    if not samples:
        return 0.0
    s = sorted(samples)
    rank = max(1, min(len(s), int(math.ceil(pct / 100.0 * len(s)))))
    return s[rank - 1]


class ServeMetrics:
    """Thread-safe serving telemetry accumulator."""

    def __init__(self, name="serve", window=None):
        if window is None:
            from .. import config

            window = config.get("MXNET_SERVE_METRICS_WINDOW")
        self.name = name
        self._window = int(window)
        self._lock = threading.Lock()
        self._latency_ms = collections.deque(maxlen=int(window))
        self._queue_ms = collections.deque(maxlen=int(window))
        self._exec_ms = collections.deque(maxlen=int(window))
        # per-priority-class latency rings, materialized on first use so a
        # priority-free deployment's snapshot stays byte-identical
        self._class_lat = {}
        self.requests = 0
        self.errors = 0
        self.rejects = 0
        self.batches = 0
        self._batch_size_sum = 0
        self._occupancy_sum = 0.0
        self.tokens = 0
        self._token_time_s = 0.0
        self.queue_depth = 0  # gauge, written by the batcher
        # overload-safety counters (deadline + shed + drain)
        self.sheds = collections.Counter()             # priority -> count
        self.deadline_expired = collections.Counter()  # stage -> count
        self.goodput = 0          # ok completions inside their deadline
        self.late_completions = 0  # delivered past deadline (inside grace)
        self.rate_limited = 0
        self.swaps = 0
        # decode-rung gauges: footprint of the pooled KV rings or pages
        # and which decode path this server runs
        self.kv_cache_bytes = 0
        self.decode_path = None
        # continuous-batching telemetry: streaming SLOs
        # (time-to-first-token, inter-token latency) plus the paged-KV and
        # slot-occupancy gauges the scheduler publishes between steps
        self._ttft_ms = collections.deque(maxlen=int(window))
        self._itl_ms = collections.deque(maxlen=int(window))
        self._itl_live = collections.deque(maxlen=int(window))
        self.kv_pages_used = 0
        self.kv_pages_free = 0
        self.slots_live = 0
        self.slots_total = 0
        # prefix-cache telemetry: cross-request KV reuse
        # through the radix trie over the paged pool
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_skipped = 0
        self.prefix_pages_shared = 0
        self.prefix_pages_held = 0
        self.prefix_evictions = 0
        # attribution gauges: the scheduler publishes
        # its Ledger's steady-state readout here so it rides the
        # serve.<name>.* export surface
        self.host_overhead_fraction = 0.0
        self.device_ms_per_token = 0.0
        # optional SLO burn-rate monitor (profiler.slo.SLOMonitor
        # .attach()); None keeps every observation at one branch
        self.slo = None
        _instances.add(self)

    # -- observations -------------------------------------------------------
    def observe_request(self, queue_ms=0.0, exec_ms=0.0, ok=True,
                        priority=None, deadline_ok=True):
        """One request completed (or failed after admission).
        ``priority`` feeds the per-class percentile rings; ``deadline_ok``
        False marks a completion that was delivered late (inside grace) —
        it counts against goodput."""
        total = queue_ms + exec_ms
        with self._lock:
            self.requests += 1
            if not ok:
                self.errors += 1
            elif deadline_ok:
                self.goodput += 1
            else:
                self.late_completions += 1
            self._latency_ms.append(total)
            self._queue_ms.append(queue_ms)
            self._exec_ms.append(exec_ms)
            if priority is not None:
                ring = self._class_lat.get(priority)
                if ring is None:
                    ring = self._class_lat.setdefault(
                        priority,
                        collections.deque(maxlen=self._window))
                ring.append(total)
        slo = self.slo
        if slo is not None:
            slo.observe("completion", ok=ok, deadline_ok=deadline_ok)
        if _prof.ENABLED:
            t1 = _prof.begin()
            _prof.record_duration(f"serve::request({self.name})", "serve",
                                  t1 - int(total * 1e6), t1,
                                  args={"queue_ms": round(queue_ms, 3),
                                        "exec_ms": round(exec_ms, 3),
                                        "ok": bool(ok)})

    def observe_batch(self, size, capacity):
        """One batch dispatched: ``size`` live requests padded into a
        ``capacity``-slot bucket (occupancy = size/capacity)."""
        occ = size / capacity if capacity else 0.0
        with self._lock:
            self.batches += 1
            self._batch_size_sum += size
            self._occupancy_sum += occ
        if _prof.ENABLED:
            _prof.record_instant(f"serve::batch({self.name})", "serve",
                                 args={"size": size, "capacity": capacity,
                                       "occupancy": round(occ, 3)})

    def observe_reject(self):
        """One fast-rejected submission (queue full / breaker open)."""
        with self._lock:
            self.rejects += 1
        _recorder.note("reject", f"serve.reject({self.name})")
        if _prof.ENABLED:
            _prof.record_instant(f"serve::reject({self.name})", "serve")

    def observe_shed(self, priority, reason="pressure"):
        """One request shed by the overload policy (always the lowest
        priority class present — ``reason`` says which mechanism fired:
        ``pressure`` for queue-displacement, ``rate`` for the token
        bucket, ``share`` for the batch-class queue-share cap)."""
        with self._lock:
            self.sheds[priority] += 1
            if reason == "rate":
                self.rate_limited += 1
        _recorder.note("shed", f"serve.shed({self.name})",
                       {"priority": priority, "reason": reason})
        if _prof.ENABLED:
            _prof.record_instant(f"serve::shed({self.name})", "serve",
                                 args={"priority": priority,
                                       "reason": reason})

    def observe_deadline(self, stage, priority=None):
        """One request cancelled at a stage boundary because its deadline
        passed (``admit`` / ``queue`` / ``execute`` / ``decode``)."""
        with self._lock:
            self.deadline_expired[stage] += 1
        _recorder.note("deadline", f"serve.deadline({self.name})",
                       {"stage": stage, "priority": priority})
        if _prof.ENABLED:
            _prof.record_instant(f"serve::deadline({self.name})", "serve",
                                 args={"stage": stage,
                                       "priority": priority})

    def observe_swap(self, mode, wall_s=0.0):
        """One model hot-swap completed (``warm`` = weights transplanted
        into the live executables, ``cold`` = fresh compile)."""
        with self._lock:
            self.swaps += 1
        if _prof.ENABLED:
            _prof.record_instant(f"serve::swap({self.name})", "serve",
                                 args={"mode": mode,
                                       "wall_s": round(wall_s, 3)})

    def observe_tokens(self, n, dt_s):
        """``n`` tokens decoded in ``dt_s`` seconds."""
        with self._lock:
            self.tokens += int(n)
            self._token_time_s += float(dt_s)
        if _prof.ENABLED and dt_s > 0:
            _prof.set_counter(f"serve.tokens_s({self.name})",
                              round(n / dt_s, 1), cat="serve")

    def observe_ttft(self, ms, priority=None):
        """Time-to-first-token for one request: admission to the first
        sampled token (prefill completes). THE interactive-latency SLO
        under continuous batching — admission waits show up here."""
        with self._lock:
            self._ttft_ms.append(float(ms))
        slo = self.slo
        if slo is not None:
            slo.observe("ttft_ms", float(ms))
        if _prof.ENABLED:
            _prof.record_instant(f"serve::ttft({self.name})", "serve",
                                 args={"ms": round(float(ms), 3),
                                       "priority": priority})

    def observe_itl(self, ms, live=1, tokens=1):
        """Inter-token latency: wall time of one decode host visit,
        observed once per visit for every live slot. Its p99 bounds how
        long any request's token stream can stall — including stalls
        caused by other requests' admissions/prefills. ``live`` is the
        step's live-slot count, so attribution can normalize device
        cost by occupancy (a 1-live step and a 16-live step are not the
        same sample).

        ``tokens`` is how many decode iterations the visit ran (1 for
        the classic loop, up to N for a multi-step super-step): a visit
        producing k tokens records k amortized token-to-token gaps of
        ``ms/k`` each, because that is what each consumer-visible gap
        actually was. Recording one giant k-iteration gap instead would
        silently inflate ITL p50/p99 by ~k and trip the SLO burn-rate
        monitor on a healthy server."""
        tokens = max(1, int(tokens))
        gap = float(ms) / tokens
        with self._lock:
            for _ in range(tokens):
                self._itl_ms.append(gap)
                self._itl_live.append(int(live))
        slo = self.slo
        if slo is not None:
            for _ in range(tokens):
                slo.observe("itl_ms", gap)

    def observe_prefix(self, matched_tokens):
        """One admission consulted the prefix trie: ``matched_tokens``
        prompt tokens (a whole number of KV pages) were already cached
        and skip prefill entirely; 0 counts as a miss."""
        with self._lock:
            if matched_tokens > 0:
                self.prefix_hits += 1
                self.prefix_tokens_skipped += int(matched_tokens)
            else:
                self.prefix_misses += 1
        if _prof.ENABLED:
            _prof.record_instant(f"serve::prefix({self.name})", "serve",
                                 args={"matched": int(matched_tokens)})

    def set_prefix_gauges(self, pages_shared, pages_held, evictions):
        """Gauge triple the scheduler publishes between steps: pool pages
        referenced more than once, pages the trie holds, and cumulative
        LRU evictions under pool pressure."""
        self.prefix_pages_shared = int(pages_shared)
        self.prefix_pages_held = int(pages_held)
        self.prefix_evictions = int(evictions)
        if _prof.ENABLED:
            _prof.set_counter(f"serve.prefix_pages_shared({self.name})",
                              int(pages_shared), cat="serve")

    def set_kv_pages(self, used, free):
        """Gauge pair: paged-KV pool occupancy (null page excluded)."""
        self.kv_pages_used = int(used)
        self.kv_pages_free = int(free)
        if _prof.ENABLED:
            _prof.set_counter(f"serve.kv_pages_used({self.name})",
                              int(used), cat="serve")

    def set_slot_occupancy(self, live, total):
        """Gauge pair: decode slots holding a live request vs the
        fixed slot count."""
        self.slots_live = int(live)
        self.slots_total = int(total)
        if _prof.ENABLED:
            _prof.set_counter(f"serve.slots_live({self.name})",
                              int(live), cat="serve")

    def set_attribution(self, host_overhead_fraction, device_ms_per_token):
        """Gauge pair the attribution ledger publishes between steps:
        the fraction of windowed decode wall NOT spent in the blocking
        device window, and device ms per emitted token."""
        self.host_overhead_fraction = float(host_overhead_fraction)
        self.device_ms_per_token = float(device_ms_per_token)
        if _prof.ENABLED:
            _prof.set_counter(
                f"serve.host_overhead_fraction({self.name})",
                round(float(host_overhead_fraction), 4), cat="serve")
            _prof.set_counter(
                f"serve.device_ms_per_token({self.name})",
                round(float(device_ms_per_token), 4), cat="serve")

    def set_queue_depth(self, depth):
        self.queue_depth = int(depth)
        if _prof.ENABLED:
            _prof.set_counter(f"serve.queue_depth({self.name})", int(depth),
                              cat="serve")

    def set_kv_cache_bytes(self, nbytes):
        """Gauge: total bytes of the server's KV-cache rings or pages."""
        self.kv_cache_bytes = int(nbytes)
        if _prof.ENABLED:
            _prof.set_counter(f"serve.kv_cache_bytes({self.name})",
                              int(nbytes), cat="serve")

    def set_decode_path(self, path):
        """Gauge: the decode rung this server runs
        ("baseline" | "pallas" | "int8")."""
        self.decode_path = str(path)
        if _prof.ENABLED:
            _prof.record_instant(f"serve::decode_path({self.name})", "serve",
                                 args={"path": str(path)})

    # -- readout ------------------------------------------------------------
    def itl_samples(self):
        """Windowed ``(ms, live)`` pairs, oldest first — the raw decode
        iteration record attribution normalizes by occupancy."""
        with self._lock:
            return list(zip(self._itl_ms, self._itl_live))

    def latency_percentiles(self):
        with self._lock:
            lat = list(self._latency_ms)
        return {"p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                "p99_ms": percentile(lat, 99)}

    def class_percentiles(self):
        """Per-priority-class latency percentiles: ``{priority: {p50_ms,
        p95_ms, p99_ms, n}}`` — the overload SLO surface (the bound is on
        the *interactive* class, not the blended window)."""
        with self._lock:
            rings = {k: list(v) for k, v in self._class_lat.items()}
        return {k: {"p50_ms": percentile(v, 50),
                    "p95_ms": percentile(v, 95),
                    "p99_ms": percentile(v, 99),
                    "n": len(v)}
                for k, v in rings.items()}

    def snapshot(self):
        """Full SLO readout (the JAX package's snapshot keys)."""
        with self._lock:
            lat = list(self._latency_ms)
            q = list(self._queue_ms)
            e = list(self._exec_ms)
            ttft = list(self._ttft_ms)
            itl = list(self._itl_ms)
            itl_live = list(self._itl_live)
            batches = self.batches
            out = {
                "name": self.name,
                "requests": self.requests,
                "errors": self.errors,
                "rejects": self.rejects,
                "batches": batches,
                "queue_depth": self.queue_depth,
                "mean_batch_size": (self._batch_size_sum / batches
                                    if batches else 0.0),
                "batch_occupancy": (self._occupancy_sum / batches
                                    if batches else 0.0),
                "tokens": self.tokens,
                "tokens_s": (self.tokens / self._token_time_s
                             if self._token_time_s > 0 else 0.0),
                "sheds": dict(self.sheds),
                "deadline_expired": dict(self.deadline_expired),
                "goodput": self.goodput,
                "late_completions": self.late_completions,
                "rate_limited": self.rate_limited,
                "swaps": self.swaps,
                "kv_cache_bytes": self.kv_cache_bytes,
                "decode_path": self.decode_path,
                "kv_pages_used": self.kv_pages_used,
                "kv_pages_free": self.kv_pages_free,
                "slots_live": self.slots_live,
                "slots_total": self.slots_total,
                "slot_occupancy": (self.slots_live / self.slots_total
                                   if self.slots_total else 0.0),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": (
                    self.prefix_hits
                    / (self.prefix_hits + self.prefix_misses)
                    if (self.prefix_hits + self.prefix_misses) else 0.0),
                "prefix_tokens_skipped": self.prefix_tokens_skipped,
                "prefix_pages_shared": self.prefix_pages_shared,
                "prefix_pages_held": self.prefix_pages_held,
                "prefix_evictions": self.prefix_evictions,
                "host_overhead_fraction": self.host_overhead_fraction,
                "device_ms_per_token": self.device_ms_per_token,
            }
        out["ttft_p50_ms"] = percentile(ttft, 50)
        out["ttft_p95_ms"] = percentile(ttft, 95)
        out["ttft_p99_ms"] = percentile(ttft, 99)
        out["itl_p50_ms"] = percentile(itl, 50)
        out["itl_p99_ms"] = percentile(itl, 99)
        out["itl_live_mean"] = (sum(itl_live) / len(itl_live)
                                if itl_live else 0.0)
        out["class_percentiles"] = self.class_percentiles()
        out["p50_ms"] = percentile(lat, 50)
        out["p95_ms"] = percentile(lat, 95)
        out["p99_ms"] = percentile(lat, 99)
        out["queue_p99_ms"] = percentile(q, 99)
        out["exec_p99_ms"] = percentile(e, 99)
        return out
