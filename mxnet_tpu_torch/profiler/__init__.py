"""Host-side telemetry of the port (counterpart of ``mxnet_tpu/profiler``,
the modules the serving stack writes to):

* ``core``        — the event bus: ranges, instants, counters, chrome
  trace dump (:func:`core.start` / :func:`core.stop` gate it);
* ``recorder``    — the always-on flight-recorder ring;
* ``trace``       — request-scoped traces with spans and flow arrows
  (``MXNET_TRACE=1`` or :func:`trace.enable`);
* ``attribution`` — the decode critical-path ledger
  (``MXNET_ATTRIBUTION=1`` or :func:`attribution.enable`).

All of it is host-only Python. The JAX package's XLA capture readers,
export endpoints and SLO monitor are not ported yet (ROADMAP A.3).
"""
from __future__ import annotations

from .. import config as _cfg
from . import attribution, core, recorder, trace
from .core import register_thread_name

__all__ = ["attribution", "core", "recorder", "trace",
           "register_thread_name"]

# MXNET_TRACE=1: request-scoped tracing on from import (span events land
# only while the bus records; the in-process summaries work either way)
if _cfg.get("MXNET_TRACE"):
    trace.enable(max_traces=_cfg.get("MXNET_TRACE_MAX"))
# MXNET_ATTRIBUTION=1: the decode ledger on from import
if _cfg.get("MXNET_ATTRIBUTION"):
    attribution.enable()
