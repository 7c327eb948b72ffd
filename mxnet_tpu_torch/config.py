"""Environment flags the port reads (its own copy of the registry in
``mxnet_tpu/config.py``, restricted to the flags of the ported modules,
with the JAX package's defaults).

Values are read live: ``get`` parses the environment on every call, so a
flag set before a :class:`~mxnet_tpu_torch.serve.Generator` is built takes
effect for it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    doc: str
    parse: Callable[[str], Any]


_FLAGS: Dict[str, Flag] = {}


def _bool(s: str) -> bool:
    return s not in ("0", "false", "False", "")


def register_flag(name, default, doc, parse=str):
    _FLAGS[name] = Flag(name, default, doc, parse)
    return _FLAGS[name]


def get(name):
    """Typed value of a registered flag (env wins over default)."""
    flag = _FLAGS[name]
    raw = os.environ.get(name)
    if raw is None:
        return flag.default
    return flag.parse(raw)


register_flag(
    "MXNET_SERVE_STRICT_PARITY", False,
    "Pin serve.Generator to the strict decode path (the 'baseline' rung), "
    "overriding any decode_path argument or MXNET_SERVE_DECODE_PATH. The "
    "port has no baseline rung yet, so a Generator built with this flag "
    "set raises NotImplementedError.", _bool)
register_flag(
    "MXNET_SERVE_DECODE_PATH", "auto",
    "Default decode rung for serve.Generator when the constructor passes "
    "none: auto (= pallas), baseline (strict ops; not ported yet), pallas "
    "(hand-written CUDA decode-attention kernel), int8 (pallas + int8 "
    "KV-cache rings and, per MXNET_SERVE_DECODE_INT8_WEIGHTS, weights).",
    str)
register_flag(
    "MXNET_SERVE_DECODE_INT8_WEIGHTS", "auto",
    "On the int8 decode rung, also pre-quantize the model's serving "
    "projection weights to per-channel int8 (ops.nn.quantized_dense). "
    "auto (default): on for a model on a CUDA device, whose projections "
    "then run the int8 x int8 kernel (ops.hopper.int8_dense), off on the "
    "CPU, where quantized_dense dequantizes the weight to f32 (as the JAX "
    "package turns it on for int8-matrix-unit backends only); 1/0 force it "
    "on/off. The KV-cache rings stay int8 either way.", str)
register_flag(
    "MXNET_SERVE_KV_PAGED", False,
    "Back serve.Generator KV state with the paged block pool "
    "(serve.kv_blocks.PagedKVPool, fully assigned) instead of contiguous "
    "per-bucket rings. (serve.ContinuousEngine is always paged.)", _bool)
register_flag(
    "MXNET_SERVE_KV_PAGE_SIZE", 0,
    "KV page width in tokens for the paged block allocator. 0 (default): "
    "the decode-attention kernel's natural block (32, its KV tile) clamped "
    "to max_seq, so a row's work stops at a whole page. max_seq must be a "
    "whole number of pages.", int)
register_flag(
    "MXNET_SERVE_KV_PAGES", 0,
    "Paged-KV pool capacity in pages (including the reserved null page). "
    "0 (default): auto-size to full capacity — every slot can hold "
    "max_seq and exhaustion is impossible. Smaller values oversubscribe: "
    "admission raises PoolExhausted (503) until retirements recycle "
    "pages.", int)
register_flag(
    "MXNET_SERVE_PREFIX_CACHE", False,
    "Cross-request KV prefix reuse (serve.prefix_cache.PrefixCache): a "
    "radix trie over prompt token ids maps matched prefixes to "
    "refcounted pages in the paged KV pool, so admission skips the "
    "matched portion of prefill. Shared pages are read-only "
    "(copy-on-extend at page granularity); LRU eviction reclaims cached "
    "prefixes only under pool pressure. Greedy outputs stay "
    "token-identical to a cache-off run.", _bool)
register_flag(
    "MXNET_SERVE_MULTISTEP", False,
    "Run the decode loop as device-side multi-step super-steps: one "
    "CUDA-graph replay executes up to MXNET_SERVE_DECODE_STEPS decode "
    "iterations (model forward + on-device sampling + stop/budget "
    "freezing) per host visit, and the host settles the returned "
    "(slots, N) token block in one pass. Off (default): one host visit "
    "per token.", _bool)
register_flag(
    "MXNET_SERVE_DECODE_STEPS", 8,
    "Decode iterations per multi-step super-step (N, the captured "
    "graph's trip count). The host can lower a visit to 1 iteration "
    "through a second graph per batch bucket — tight deadlines "
    "auto-degrade to single-step so 504 retirement latency stays "
    "bounded by one iteration.", int)
register_flag(
    "MXNET_SERVE_SPEC_TOKENS", 4,
    "Draft tokens proposed per speculative-decoding round "
    "(serve.SpeculativeGenerator's default k): each round costs k+1 draft "
    "iterations (one super-step replay with multistep) plus one "
    "(k+1)-wide target verify pass.", int)
register_flag(
    "MXNET_SERVE_TIMEOUT_MS", 0.0,
    "Per-execution watchdog for serve.InferenceSession and the graph "
    "sessions' replays: a hung execution becomes a fast "
    "ServiceUnavailable (503) after this many ms instead of wedging the "
    "serving thread. Off until a session's warmup has frozen its "
    "signatures. 0 disables (the body runs inline).",
    float)
register_flag(
    "MXNET_SERVE_BREAKER_THRESHOLD", 3,
    "Consecutive InferenceSession execution failures that trip the "
    "session circuit breaker open (requests fast-reject until cooldown).",
    int)
register_flag(
    "MXNET_SERVE_BREAKER_COOLDOWN", 8,
    "Rejected calls the serve breaker stays open before letting one "
    "half-open probe re-test the session.", int)
register_flag(
    "MXNET_SERVE_MAX_MODELS", 4,
    "Resident-model budget for serve.tenancy.ModelRegistry: at most this "
    "many named models (engine, KV pool, prefix trie, captured graphs) "
    "stay loaded per process; loading past the budget LRU-evicts the "
    "coldest idle tenant, which reloads through its factory on next "
    "use.", int)
register_flag(
    "MXNET_COLLECTIVE_TIMEOUT", 0.0,
    "Seconds before resilience.retry's watchdog declares a hung body and "
    "raises CollectiveTimeoutError. 0 disables the watchdog.", float)
register_flag(
    "MXNET_COMPILE_MAX_RETRIES", 2,
    "Extra attempts of resilience.retry.compile_policy() for a "
    "transiently-failing build.", int)
register_flag(
    "MXNET_COLLECTIVE_MAX_RETRIES", 2,
    "Extra attempts of resilience.retry.collective_policy() for a "
    "transiently-failing collective.", int)
register_flag(
    "MXNET_RETRY_BASE_DELAY_MS", 5.0,
    "First retry backoff delay in ms; doubles per attempt.", float)
register_flag(
    "MXNET_RETRY_MAX_DELAY_MS", 250.0,
    "Backoff delay ceiling in ms.", float)
register_flag(
    "MXNET_FLEET_HEDGE_MS", 0.0,
    "Hedged-retry delay for serve.fleet.Router: an interactive request "
    "dispatched to a replica flagged straggling gets a second (hedge) "
    "dispatch to the next-best replica after this many ms unless it has "
    "already settled; first settle wins. Batch-class requests are never "
    "hedged, and a request is never hedged twice. 0 (default) disables "
    "hedging.", float)
register_flag(
    "MXNET_FLEET_STRAGGLER_MS", 150.0,
    "Per-replica latency-lag EWMA (vs the fleet median, "
    "resilience.elastic.StragglerMonitor) above which the Router flags a "
    "replica as straggling, the precondition for a hedge. 0: track only, "
    "never flag.", float)
register_flag(
    "MXNET_FLEET_MAX_FAILOVERS", 2,
    "Times the Router re-dispatches one request to a surviving replica "
    "after replica deaths or quarantines before failing it with "
    "ServiceUnavailable.", int)
register_flag(
    "MXNET_FLEET_PROBE_MS", 25.0,
    "Router supervisor probe interval: how often each replica's liveness "
    "(flusher thread) and session breaker are checked, so a replica that "
    "died between dispatches is still detected and its in-flight work "
    "failed over. 0 disables the supervisor thread.", float)
register_flag(
    "MXNET_FLEET_BREAKER_THRESHOLD", 2,
    "Consecutive replica-attributed dispatch/settle failures that "
    "quarantine a replica behind the Router's per-replica circuit "
    "breaker.", int)
register_flag(
    "MXNET_FLEET_BREAKER_COOLDOWN", 8,
    "Dispatch picks a quarantined replica sits out before the Router's "
    "per-replica breaker goes half-open and routes one probe request "
    "through it.", int)
register_flag(
    "MXNET_STRAGGLER_THRESHOLD_MS", 0.0,
    "Default lag EWMA (ms) above which resilience.elastic.StragglerMonitor "
    "flags a replica. 0 (default): tracking only, never flags.", float)
register_flag(
    "MXNET_METRICS_PORT", 0,
    "Serve the unified telemetry surface (profiler.export) over stdlib "
    "HTTP on this port: /metrics (Prometheus text), /healthz (serving "
    "health JSON), /snapshot (full JSON). Unset (default): no server. "
    "Explicitly set to 0: bind an ephemeral port and report it as a "
    "MXNET_METRICS_PORT_BOUND=<port> line on stderr and "
    "profiler.export.server_port().", int)
register_flag(
    "MXNET_SLO_WINDOW_S", 60.0,
    "Default slow evaluation window (seconds) for SLO objectives "
    "(profiler.slo.SLO) built without an explicit window; the fast "
    "window defaults to 1/12 of it.", float)
register_flag(
    "MXNET_SLO_BURN_THRESHOLD", 14.4,
    "Default error-budget burn-rate alert threshold: an objective burns "
    "only when both its fast and slow windows exceed this.", float)
register_flag(
    "MXNET_SLO_EVAL_INTERVAL_S", 0.25,
    "Minimum seconds between passive SLO burn-rate evaluations on the "
    "observing thread.", float)
register_flag(
    "MXNET_SLO_MIN_EVENTS", 12,
    "Minimum fast-window events before an SLO objective may alert.", int)
register_flag(
    "MXNET_SERVE_SLOTS", 8,
    "Decode lanes for serve.scheduler.ContinuousEngine: its one decode "
    "width. Requests are admitted into free lanes and retired from "
    "finished ones between decode visits; idle lanes ride along on the "
    "null KV page.", int)
register_flag(
    "MXNET_SERVE_PREFILL_CHUNK", 0,
    "Prompt tokens prefilled per continuous-batching scheduler iteration "
    "at the fixed (1, chunk) signature. 0 (default): one KV page. Bounds "
    "how long a long prompt can stall live decode streams (one chunk per "
    "iteration).", int)
register_flag(
    "MXNET_SERVE_MAX_BATCH", 8,
    "DynamicBatcher flush size: a batch dispatches immediately once this "
    "many requests are queued.", int)
register_flag(
    "MXNET_SERVE_BATCH_TIMEOUT_MS", 5.0,
    "DynamicBatcher flush deadline: an admitted request waits at most this "
    "long for batch-mates before the partial batch dispatches.", float)
register_flag(
    "MXNET_SERVE_MAX_QUEUE", 64,
    "Admission-control cap on DynamicBatcher queue depth: submissions "
    "beyond it fast-reject with ServiceUnavailable (503).", int)
register_flag(
    "MXNET_SERVE_DEADLINE_MS", 0.0,
    "Default request deadline attached at DynamicBatcher.submit when the "
    "caller passes none: expired requests are cancelled at every stage "
    "boundary with DeadlineExceeded (504). 0 disables.", float)
register_flag(
    "MXNET_SERVE_DEADLINE_GRACE_MS", 0.0,
    "Slack past a request's deadline within which a completed result is "
    "still delivered (counted as a late completion); beyond deadline + "
    "grace the future settles with DeadlineExceeded.", float)
register_flag(
    "MXNET_SERVE_BATCH_QUEUE_SHARE", 1.0,
    "Fraction of MXNET_SERVE_MAX_QUEUE the batch priority class may "
    "occupy; batch-class submits beyond it shed with 503. 1.0 (default) "
    "reserves nothing.", float)
register_flag(
    "MXNET_SERVE_RATE_LIMIT", 0.0,
    "Token-bucket refill rate (requests/s) gating batch-class admission "
    "in DynamicBatcher.submit; interactive traffic is never rate-limited. "
    "0 disables the bucket.", float)
register_flag(
    "MXNET_SERVE_RATE_BURST", 16,
    "Token-bucket capacity for MXNET_SERVE_RATE_LIMIT.", int)
register_flag(
    "MXNET_SERVE_METRICS_WINDOW", 2048,
    "Ring-buffer sample count behind the serve latency, TTFT and ITL "
    "percentiles (serve.metrics).", int)
register_flag(
    "MXNET_FAULT_PLAN", None,
    "Fault-injection plan (resilience.faults): inline JSON or "
    "@/path/to/plan.json. Installed lazily on first use; unset disables "
    "injection.")
register_flag(
    "MXNET_TRACE", False,
    "Request-scoped tracing (profiler.trace) on from import.", _bool)
register_flag(
    "MXNET_TRACE_MAX", 1024,
    "Bounded in-process trace registry size (oldest traces evicted).", int)
register_flag(
    "MXNET_FLIGHT_RECORDER", True,
    "Always-on flight recorder (profiler.recorder): a bounded ring of "
    "recent faults, sheds, rejects, deadline expiries and escalations, "
    "dumped to JSON at breaker-open, watchdog timeout and SLO burn. 0 "
    "disables (ring writes become one bool check).", _bool)
register_flag(
    "MXNET_FLIGHT_RECORDER_SIZE", 512,
    "Flight-recorder ring capacity (most recent N notes kept).", int)
register_flag(
    "MXNET_FLIGHT_RECORDER_DIR", None,
    "Directory for automatic flight-recorder dumps "
    "(flightrec-<utc>-<reason>.json). Default: the system tempdir.")
register_flag(
    "MXNET_FLIGHT_RECORDER_MAX_DUMPS", 16,
    "Per-process cap on automatic flight-recorder dump files (first "
    "escalations win; later ones only land in the ring).", int)
register_flag(
    "MXNET_ATTRIBUTION", False,
    "Decode critical-path attribution (profiler.attribution) on from "
    "import: split every decode visit's wall time into host / dispatch / "
    "device / wait phases and publish host_overhead_fraction / "
    "device_ms_per_token through ServeMetrics.", _bool)
register_flag(
    "MXNET_ATTRIBUTION_WINDOW", 512,
    "Rolling window (decode visits) of the attribution ledger's gauges.",
    int)
register_flag(
    "MXNET_LOSS_SCALE_MIN", 1.0,
    "Lower clamp for the dynamic LossScaler (amp.py): repeated overflows "
    "can never drive the scale to 0.", float)
register_flag(
    "MXNET_LOSS_SCALE_MAX", 2.0 ** 24,
    "Upper clamp for the dynamic LossScaler: a long overflow-free run "
    "can never drive the scale to inf.", float)
