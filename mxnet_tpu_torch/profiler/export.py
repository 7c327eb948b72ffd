"""Unified telemetry export (the port's own copy of
``mxnet_tpu/profiler/export.py``, host-only): every live subsystem's
counters behind ONE ``snapshot()`` — profiler counters and aggregates,
the ``resilience.*`` counters and circuit-breaker states, per-instance
``ServeMetrics`` percentiles and goodput, the straggler monitor, the
tenancy registries, the fleet routers, the SLO monitors, the attribution
ledgers and the flight-recorder/trace bookkeeping — flattened into a
single namespaced dict (``serve.<name>.p99_ms``, ``resilience.retries``,
``fleet.<name>.live``...).

The same snapshot renders as Prometheus text exposition
(:func:`render_prometheus`) and can be served over stdlib HTTP
(:func:`start_http`, or ``MXNET_METRICS_PORT`` at import):

* ``GET /metrics``  — Prometheus text format
* ``GET /healthz``  — JSON wrapping every registered serving session's
  ``health()``/``ready()`` probes; 200 when all ready, else 503
* ``GET /snapshot`` — the full snapshot as JSON

Aggregation is *pull-based*: providers are discovered through
``sys.modules``, so a process that never imported the fleet layer never
imports it here, and instance registries are weak sets so the exporter
never pins a retired server. The JAX package's engine, compiled-op
cache, compile-cache, kvstore and input-pipeline gauges have no port
module yet, so they are absent.
"""
from __future__ import annotations

import json
import sys
import threading
import weakref

from .. import config as _cfg
from . import core as _core
from . import recorder as _recorder
from . import trace as _trace

# serving sessions answering /healthz (weak: a collected session is
# simply no longer probed). InferenceSession registers itself.
_health_providers: "weakref.WeakSet" = weakref.WeakSet()

_server = None
_server_thread = None
_server_lock = threading.Lock()


def register_health_provider(obj):
    """Register an object with ``health()``/``ready()`` (the serving
    session contract) for the ``/healthz`` endpoint."""
    _health_providers.add(obj)


def unregister_health_provider(obj):
    """Remove ``obj`` from the ``/healthz`` roll. The fleet Router calls
    this for each replica-owned session it adopts: the Router itself is
    the fleet's single health provider, so one dead (and routed-around)
    replica doesn't wedge the whole process's /healthz at 503."""
    _health_providers.discard(obj)


def _flatten(prefix, value, out):
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(k, (int, float)):
                _flatten(f"{prefix}[{k}]", v, out)
            else:
                _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(value, (list, tuple)):
        out[prefix] = json.dumps(value)
    else:
        out[prefix] = value


def snapshot(include_aggregates=True):
    """One flat ``{namespaced_name: value}`` dict over every subsystem
    currently alive in the process. Never imports a subsystem the
    process hasn't touched (``sys.modules`` discovery)."""
    out = {}

    # profiler bus: counter gauges are already namespaced at the source
    # (resilience.* / serve.* / cachedop.* / engine.* / registry.*)
    for k, v in _core.counters_snapshot().items():
        out[k] = v
    if include_aggregates:
        for name, row in _core.aggregate_stats().items():
            out[f"profiler.agg.{name}.calls"] = row["calls"]
            out[f"profiler.agg.{name}.total_s"] = row["total_s"]
    out["profiler.dropped_events"] = _core._dropped
    out["profiler.recording"] = int(_core.ENABLED)

    tenancy = sys.modules.get("mxnet_tpu_torch.serve.tenancy")
    if tenancy is not None:
        for name, snap in tenancy.registry_stats().items():
            _flatten(f"tenancy.{name}", snap, out)

    rescnt = sys.modules.get("mxnet_tpu_torch.resilience.counters")
    if rescnt is not None:
        for k, v in rescnt.snapshot().items():
            out[k] = v  # names carry the resilience. prefix already

    elastic = sys.modules.get("mxnet_tpu_torch.resilience.elastic")
    if elastic is not None and elastic._active_monitor is not None:
        _flatten("resilience.straggler",
                 elastic._active_monitor.snapshot(), out)

    retry = sys.modules.get("mxnet_tpu_torch.resilience.retry")
    if retry is not None:
        for name, bstate in retry.breaker_states().items():
            _flatten(f"resilience.breaker.{name}", bstate, out)

    smet = sys.modules.get("mxnet_tpu_torch.serve.metrics")
    if smet is not None:
        for name, snap in smet.all_snapshots().items():
            snap.pop("name", None)
            _flatten(f"serve.{name}", snap, out)

    fleet = sys.modules.get("mxnet_tpu_torch.serve.fleet")
    if fleet is not None:
        for name, snap in fleet.fleet_stats().items():
            _flatten(f"fleet.{name}", snap, out)

    slo_mod = sys.modules.get("mxnet_tpu_torch.profiler.slo")
    if slo_mod is not None:
        for name, snap in slo_mod.all_snapshots().items():
            _flatten(f"slo.{name}", snap, out)

    attr_mod = sys.modules.get("mxnet_tpu_torch.profiler.attribution")
    if attr_mod is not None:
        for name, snap in attr_mod.all_snapshots().items():
            _flatten(f"attribution.{name}", snap, out)
        for phase, ms in attr_mod.wait_ms_by_phase().items():
            out[f"attribution.wait_ms[{phase}]"] = round(ms, 3)

    out["recorder.enabled"] = int(_recorder.ENABLED)
    out["recorder.notes"] = _recorder._seq
    out["recorder.dumps"] = _recorder.dump_count()
    out["trace.enabled"] = int(_trace.ENABLED)
    with _trace._lock:
        out["trace.registered"] = len(_trace._registry)
    return out


# -- Prometheus text rendering ----------------------------------------------

def _prom_name(key):
    """``serve.smoke.p99_ms`` -> ``mxnet_serve_smoke_p99_ms``; a trailing
    ``[idx]`` subscript becomes a ``key`` label."""
    label = None
    if key.endswith("]") and "[" in key:
        key, _, sub = key.rpartition("[")
        label = sub[:-1]
    name = "mxnet_" + "".join(
        c if c.isalnum() or c == "_" else "_" for c in key)
    return name, label


def render_prometheus(snap=None):
    """Prometheus text exposition of :func:`snapshot`. Numeric values
    become gauges; string values (breaker states, paths) become
    ``<name>_info{value="..."} 1`` rows."""
    if snap is None:
        snap = snapshot(include_aggregates=False)
    lines = []
    for key in sorted(snap):
        val = snap[key]
        name, label = _prom_name(key)
        if isinstance(val, bool):
            val = int(val)
        if isinstance(val, (int, float)):
            if label is not None:
                lines.append(f'{name}{{key="{label}"}} {val}')
            else:
                lines.append(f"{name} {val}")
        elif val is not None:
            sval = str(val).replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f'{name}_info{{value="{sval}"}} 1')
    return "\n".join(lines) + "\n"


def health():
    """Merged health payload over every registered serving session."""
    sessions = {}
    ready = True
    for s in list(_health_providers):
        try:
            sessions[s.name] = s.health()
            ready = ready and bool(s.ready())
        except Exception as e:  # noqa: BLE001 -- a probe must answer
            sessions[getattr(s, "name", "?")] = {"error": str(e)}
            ready = False
    return {"ready": ready, "sessions": sessions}


# -- stdlib HTTP endpoint ----------------------------------------------------

def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib contract)
            try:
                if self.path.startswith("/metrics"):
                    body = render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                    code = 200
                elif self.path.startswith("/healthz"):
                    h = health()
                    body = json.dumps(h).encode()
                    ctype = "application/json"
                    code = 200 if h["ready"] else 503
                elif self.path.startswith("/snapshot"):
                    body = json.dumps(snapshot(), default=str).encode()
                    ctype = "application/json"
                    code = 200
                else:
                    body = b"not found\n"
                    ctype = "text/plain"
                    code = 404
            except Exception as e:  # noqa: BLE001 -- scrape must answer
                body = f"export error: {e}\n".encode()
                ctype = "text/plain"
                code = 500
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-request stderr lines
            pass

    return Handler


def start_http(port=None, host="127.0.0.1"):
    """Serve /metrics + /healthz + /snapshot on a daemon thread; returns
    the bound port (``port=0`` binds an ephemeral one). Idempotent."""
    global _server, _server_thread
    with _server_lock:
        if _server is not None:
            return _server.server_address[1]
        from http.server import ThreadingHTTPServer

        if port is None:
            port = int(_cfg.get("MXNET_METRICS_PORT"))
        srv = ThreadingHTTPServer((host, int(port)), _make_handler())
        srv.daemon_threads = True

        def _serve():
            _core.register_thread_name()
            srv.serve_forever()

        th = threading.Thread(target=_serve,
                              name="mxtpu-metrics-http", daemon=True)
        th.start()
        _server, _server_thread = srv, th
        return srv.server_address[1]


def stop_http():
    global _server, _server_thread
    with _server_lock:
        if _server is None:
            return
        srv, th = _server, _server_thread
        _server = _server_thread = None
    # shutdown + join outside _server_lock: joining the serve thread
    # while holding the lock its handlers may want is an L002 hazard
    srv.shutdown()
    srv.server_close()
    th.join(5)


def server_port():
    with _server_lock:
        return None if _server is None else _server.server_address[1]


def maybe_start_from_env():
    """``MXNET_METRICS_PORT=<p>`` starts the endpoint at import (called
    from ``profiler.__init__``). Unset: nothing. Explicitly set to
    ``0``: bind an EPHEMERAL port — the bound port is reported back via
    a ``MXNET_METRICS_PORT_BOUND=<port>`` line on stderr (greppable by
    the harness that launched the process) and :func:`server_port`."""
    import os

    raw = os.environ.get("MXNET_METRICS_PORT")
    if raw is None or not raw.strip():
        return
    try:
        port = int(raw)
    except ValueError:
        return
    if port < 0:
        return
    try:
        bound = start_http(port)
    except OSError as e:
        import warnings

        warnings.warn(f"MXNET_METRICS_PORT={port}: could not start "
                      f"metrics endpoint: {e}", RuntimeWarning)
        return
    if port == 0:
        print(f"MXNET_METRICS_PORT_BOUND={bound}", file=sys.stderr,
              flush=True)
