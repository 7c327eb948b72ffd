"""Host-side telemetry of the port (counterpart of ``mxnet_tpu/profiler``,
the modules the serving stack writes to):

* ``core``        — the event bus: ranges, instants, counters, chrome
  trace dump (:func:`core.start` / :func:`core.stop` gate it);
* ``recorder``    — the always-on flight-recorder ring and its JSON dumps;
* ``trace``       — request-scoped traces with spans and flow arrows
  (``MXNET_TRACE=1`` or :func:`trace.enable`);
* ``attribution`` — the decode critical-path ledger
  (``MXNET_ATTRIBUTION=1`` or :func:`attribution.enable`);
* ``slo``         — declarative SLOs with multi-window burn rates;
* ``export``      — one flat ``snapshot()`` over all of it, Prometheus
  text, and the ``/metrics`` / ``/healthz`` / ``/snapshot`` HTTP endpoint
  (started at import when ``MXNET_METRICS_PORT`` is set).

All of it is host-only Python.
"""
from __future__ import annotations

from .. import config as _cfg
from . import attribution, core, export, recorder, slo, trace
from .core import register_thread_name

__all__ = ["attribution", "core", "export", "recorder", "slo", "trace",
           "register_thread_name"]

# MXNET_TRACE=1: request-scoped tracing on from import (span events land
# only while the bus records; the in-process summaries work either way)
if _cfg.get("MXNET_TRACE"):
    trace.enable(max_traces=_cfg.get("MXNET_TRACE_MAX"))
# MXNET_ATTRIBUTION=1: the decode ledger on from import
if _cfg.get("MXNET_ATTRIBUTION"):
    attribution.enable()
# MXNET_METRICS_PORT=<p>: the export endpoint from import (0: ephemeral)
export.maybe_start_from_env()
