"""`InferenceSession`: bucketed serving executor (counterpart of
``mxnet_tpu/serve/engine.py``).

The session pads every call onto a small lattice of (batch, seq) buckets,
so steady-state traffic only ever runs shapes it has already seen. In the
JAX package each new shape is an XLA compile; PyTorch runs eagerly, so
here a shape signature is the unit a CUDA-graph capture keys on. The
session keeps the set of signatures it has run, and
``assert_no_recompiles`` keeps its meaning: after ``warmup`` no call
brings a new signature.

Resilience wiring, as in the JAX package (``resilience.retry``), on every
session — :class:`InferenceSession` and :class:`GraphSession` alike, as
every executable of the JAX package runs through an ``InferenceSession``:

* a :class:`~mxnet_tpu_torch.resilience.retry.CircuitBreaker` guards the
  session: repeated execution failures trip it open and requests
  fast-reject with a 503 :class:`ServiceUnavailable` until a half-open
  probe heals it. An open breaker never reroutes the call to another
  route or device;
* ``MXNET_SERVE_TIMEOUT_MS`` bounds each execution with the resilience
  watchdog — a hung execution becomes a fast 503 instead of wedging the
  serving thread. The watched body runs on the watchdog's thread, which
  makes the session's device and the caller's stream current and runs
  under ``torch.inference_mode()`` (none of these is inherited by a new
  thread). The watchdog is off until the session's signature set is
  frozen: warmup (and a cold swap's re-warm) builds kernels and captures
  graphs, which take seconds and are not hung executions, and a graph is
  never captured on the watchdog's thread;
* the ``serve:execute`` fault site fires inside the watched window;
* ``drain``/``resume`` close and reopen an admission gate that counts the
  executions in flight; a graph session shares its owner's gate, so
  draining a session also waits for (and then refuses) the graph replays
  that read the same weights. ``swap`` (warm weight transplant in place,
  or a cold block replacement) runs on a drained gate, and the
  ``health``/``ready`` probes answer for each session, registered as a
  ``profiler.export`` health provider.

Each session carries a :class:`~.metrics.ServeMetrics` (``metrics``) and
records a ``serve::session_run(<name>)`` span on the calling thread's
ambient request trace.

:class:`GraphSession` is the counterpart of the compiled executables the
JAX package keeps per signature: on a GPU it captures one CUDA graph per
signature key and replays it, with the same signature accounting.
"""
from __future__ import annotations

import itertools
import threading
import time

import numpy as _onp
import torch

from .. import config
from .. import device as _device
from ..base import MXNetError
from ..profiler import core as _prof
from ..profiler import export as _export
from ..profiler import trace as _trace
from ..resilience import faults as _faults
from ..resilience.retry import CircuitBreaker, CollectiveTimeoutError, \
    run_with_watchdog, watchdog_orphans
from .metrics import ServeMetrics


class ServeError(MXNetError):
    """Base class for serving-path errors; carries an HTTP-style status."""

    status = 500
    #: back-off hint (ms) for overload-shaped rejects; ``None`` on
    #: structural failures a retry won't fix
    retry_after_ms = None


class ServiceUnavailable(ServeError):
    """Fast-reject: the server cannot take the request now (503)."""

    status = 503


class PoolExhausted(ServiceUnavailable):
    """The paged KV block pool has no free pages for a new admission
    (503-shaped: capacity frees as in-flight requests retire and their
    pages recycle). Raised by :class:`~mxnet_tpu_torch.serve.kv_blocks.
    PagedKVPool`, with a ``retry_after_ms`` hint; the continuous
    engine requeues the request instead of failing it."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before (or while) it was served (504).

    Distinct from :class:`ServiceUnavailable` on purpose: a 503 means the
    *server* shed or failed the request and a retry may succeed; a 504
    means the *request's own time budget* ran out. Raised at every stage
    boundary (admission, queue sweep, settle, between decode visits); a
    request that expires mid-decode carries the tokens generated so far
    in ``.partial``.
    """

    status = 504


def pick_bucket(n, buckets):
    """Smallest bucket >= n; raises :class:`ServeError` when n overflows
    the largest bucket (the request can never be served — reject it
    loudly rather than silently truncating)."""
    for b in buckets:
        if n <= b:
            return b
    raise ServeError(
        f"request size {n} exceeds the largest configured bucket "
        f"{buckets[-1]}; raise the session's bucket lattice or shard the "
        "request")


def _signature(args):
    return tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a)
                 else (type(a).__name__,) for a in args)


class _Gate:
    """Admission gate: the executions in flight that :meth:`drain` waits
    on, the draining flag, and the per-thread bypass that a swap's own
    re-warm runs under while external admission is still stopped. A
    :class:`GraphSession` shares its owner's gate."""

    __slots__ = ("cond", "inflight", "draining", "bypass")

    def __init__(self):
        self.cond = threading.Condition()
        self.inflight = 0
        self.draining = False
        self.bypass = threading.local()


class _Guarded:
    """The protection stack every serving session runs its executions
    under (breaker -> fault site -> watchdog, inside an admission gate),
    and the drain/resume and health/ready probes over it. A subclass
    sets ``device`` and ``_warm_signatures`` and calls
    :meth:`_guard_init`."""

    def _guard_init(self, name, gate=None):
        self.name = name
        self.metrics = ServeMetrics(name)
        self.breaker = CircuitBreaker(
            failure_threshold=config.get("MXNET_SERVE_BREAKER_THRESHOLD"),
            cooldown_calls=config.get("MXNET_SERVE_BREAKER_COOLDOWN"),
            name=f"serve:{name}")
        self._gate = gate if gate is not None else _Gate()
        # unified export surface: /healthz wraps this session's probes
        _export.register_health_provider(self)

    def _timeout_s(self):
        # off until the signature set is frozen: warmup and a cold swap's
        # re-warm build kernels and capture graphs
        if self._warm_signatures is None:
            return 0.0
        return config.get("MXNET_SERVE_TIMEOUT_MS") / 1e3

    def _protected(self, execute, prepare=None):
        """Run ``execute()`` under the protection stack: admission (503
        while draining), breaker (503 while open), then ``prepare()`` on
        the calling thread (signature accounting, a graph capture), then
        the ``serve:execute`` fault site and ``execute()`` under
        ``torch.inference_mode()`` inside the watchdog window. A timeout
        is a 503; any other failure counts against the breaker and
        propagates unchanged."""
        gate = self._gate
        with gate.cond:
            if gate.draining and not getattr(gate.bypass, "on", False):
                self.metrics.observe_reject()
                raise ServiceUnavailable(
                    f"serve session {self.name!r} is draining; no new "
                    "work admitted until swap/resume")
            gate.inflight += 1
        try:
            if not self.breaker.allow():
                self.metrics.observe_reject()
                raise ServiceUnavailable(
                    f"serve session {self.name!r}: circuit breaker is "
                    f"{self.breaker.state} after repeated execution "
                    "failures; retry after cooldown")
            timeout = self._timeout_s()
            device = self.device
            stream = (torch.cuda.current_stream(device)
                      if timeout > 0 and device.type == "cuda" else None)

            def watched():
                # fault site INSIDE the watchdog window: an injected delay
                # models a hung execution and must trip the timeout
                _faults.fault_point("serve:execute", {"session": self.name})
                with torch.inference_mode():
                    return execute()

            def body():
                if stream is None:
                    return watched()
                # on the watchdog's thread nothing of the caller's
                # per-thread state is inherited
                torch.cuda.set_device(device)
                with torch.cuda.stream(stream):
                    return watched()

            t0 = time.perf_counter()
            try:
                with _trace.span(f"serve::session_run({self.name})"):
                    if prepare is not None:
                        prepare()
                    out = run_with_watchdog(body, timeout,
                                            site=f"serve:{self.name}")
            except CollectiveTimeoutError as exc:
                self.breaker.record_failure()
                raise ServiceUnavailable(
                    f"serve session {self.name!r}: execution exceeded "
                    f"MXNET_SERVE_TIMEOUT_MS ({exc})") from exc
            except Exception:
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
            if _prof.ENABLED:
                _prof.record_instant(
                    f"serve::execute({self.name})", "serve",
                    args={"exec_ms": round(
                        (time.perf_counter() - t0) * 1e3, 3)})
            return out
        finally:
            with gate.cond:
                gate.inflight -= 1
                if gate.inflight == 0:
                    gate.cond.notify_all()

    # -- drain / health ------------------------------------------------------
    def drain(self, timeout=30.0):
        """Stop admitting work and wait for every in-flight execution to
        settle (on a shared gate: the owner's and its graph sessions').
        Returns True once quiesced, False on timeout (admission stays
        stopped either way — call :meth:`resume` to reopen, or
        ``swap`` which resumes itself). Idempotent."""
        deadline = time.monotonic() + float(timeout)
        gate = self._gate
        with gate.cond:
            gate.draining = True
            while gate.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                gate.cond.wait(remaining)
        if _prof.ENABLED:
            _prof.record_instant(f"serve::drain({self.name})", "serve")
        return True

    def resume(self):
        """Reopen admission after :meth:`drain`."""
        with self._gate.cond:
            self._gate.draining = False
            self._gate.cond.notify_all()

    def health(self):
        """Liveness probe payload: lifecycle state, breaker, in-flight
        count, error rate over the metrics window, warm flag, watchdog
        orphans. Always answers (a wedged executor is the watchdog's
        problem, not the probe's)."""
        snap = self.metrics.snapshot()
        with self._gate.cond:
            draining = self._gate.draining
            inflight = self._gate.inflight
        requests = snap["requests"]
        out = {
            "state": "draining" if draining else "serving",
            "ready": self.ready(),
            "warm": self._warm_signatures is not None,
            "inflight": inflight,
            "breaker": self.breaker.snapshot(),
            "error_rate": (snap["errors"] / requests) if requests else 0.0,
            "rejects": snap["rejects"],
            "sheds": snap["sheds"],
            "deadline_expired": snap["deadline_expired"],
            "watchdog_orphans": watchdog_orphans(),
        }
        # SLO burn: degraded, not dead — ready() is untouched (an SLO
        # violation is a page, not a kill switch), the probe just says so
        slo_mon = getattr(self.metrics, "slo", None)
        if slo_mon is not None:
            out["slo"] = slo_mon.health()
            if out["slo"]["state"] == "degraded":
                out["state"] = "degraded"
        return out

    def ready(self):
        """Readiness probe: warm (signature set frozen), admitting (not
        draining), and the breaker is not open. A False here is the load
        balancer's cue to route around this replica."""
        with self._gate.cond:
            if self._gate.draining:
                return False
        return (self._warm_signatures is not None
                and self.breaker.state != "open")


class InferenceSession(_Guarded):
    """Bucketed, breaker-guarded executor for one module.

    Parameters
    ----------
    block : torch.nn.Module
        The model; called under ``torch.inference_mode()``.
    batch_buckets : sequence of int
        Ascending batch-size lattice; :meth:`predict` pads the leading axis
        up to one of these.
    seq_buckets : sequence of int, optional
        Ascending sequence-length lattice for axis 1 of 2-D+ inputs
        (token arrays). ``None`` disables seq padding.
    pad_value : scalar
        Fill for padded sequence positions (token id 0 by default).
    device : the device :meth:`predict` puts its inputs on; by default the
        device of the block's parameters (or buffers, for a module such as
        ``FusedResNetV1`` that holds its weights as buffers).
    """

    def __init__(self, block, batch_buckets=(1, 2, 4, 8), seq_buckets=None,
                 pad_value=0, name=None, device=None):
        self.block = block
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        self.seq_buckets = (tuple(sorted(int(s) for s in seq_buckets))
                            if seq_buckets else None)
        self.pad_value = pad_value
        self.device = _device.resolve(device if device is not None
                                      else _block_device(block))
        self._signatures = set()
        self._warm_signatures = None
        self._hits = 0       # calls whose signature had run before
        self._misses = 0     # calls that brought a new signature
        self._lock = threading.Lock()
        self._guard_init(name or type(block).__name__)

    # -- raw protected execution -------------------------------------------
    def run(self, *args):
        """Execute one already-bucketed call under the protection stack
        (breaker -> fault site -> watchdog -> the module under
        ``torch.inference_mode()``), recording its shape signature.
        Raises :class:`ServiceUnavailable` on a draining session, an open
        breaker or a timeout; any other failure propagates unchanged (a
        batcher or the continuous engine maps it onto the requests inside
        the call)."""
        def prepare():
            sig = _signature(args)
            with self._lock:
                if sig in self._signatures:
                    self._hits += 1
                else:
                    self._misses += 1
                    self._signatures.add(sig)

        block = self.block
        return self._protected(lambda: block(*args), prepare)

    # -- bucketed predict ---------------------------------------------------
    def _pad_input(self, data):
        """Pad a host array onto the bucket lattice. Returns
        (padded tensor on the session's device, real_batch, real_seq)."""
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        data = _onp.asarray(data)
        b = data.shape[0]
        bb = pick_bucket(b, self.batch_buckets)
        padded = data
        if bb > b:
            # batch rows pad by edge-repeat (a real row: no NaN/denormal
            # surprises in the dead lanes)
            padded = _onp.pad(padded,
                              [(0, bb - b)] + [(0, 0)] * (data.ndim - 1),
                              mode="edge")
        t = None
        if self.seq_buckets is not None and data.ndim > 1:
            t = data.shape[1]
            st = pick_bucket(t, self.seq_buckets)
            if st > t:  # seq positions pad with pad_value
                seq_w = [(0, 0), (0, st - t)] + [(0, 0)] * (data.ndim - 2)
                padded = _onp.pad(padded, seq_w, mode="constant",
                                  constant_values=self.pad_value)
        return torch.as_tensor(padded, device=self.device), b, t

    def predict(self, data):
        """Serve one request batch: pad onto the bucket lattice, execute,
        slice the outputs back to the real request shape — the batch
        axis always, and the seq axis of any output that kept the padded
        seq extent."""
        padded, b, t = self._pad_input(data)
        st = padded.shape[1] if padded.dim() > 1 else None
        out = self.run(padded)

        def unpad(o):
            o = o[:b]
            if t is not None and t != st and o.dim() >= 2 \
                    and o.shape[1] == st:
                o = o[:, :t]
            return o

        if isinstance(out, (tuple, list)):
            return type(out)(unpad(o) for o in out)
        return unpad(out)

    def __call__(self, data):
        return self.predict(data)

    # -- warmup & signature accounting --------------------------------------
    def warmup(self, example):
        """Run every (batch, seq) bucket combination once from one example
        input (an array shaped like a single request batch), then freeze
        the signature set (the watchdog is off until then). Returns the
        signature count."""
        if torch.is_tensor(example):
            example = example.detach().cpu().numpy()
        example = _onp.asarray(example)
        row = example[:1]
        for bb in self.batch_buckets:
            tiled = _onp.repeat(row, bb, axis=0)
            if self.seq_buckets is not None and example.ndim > 1:
                for st in self.seq_buckets:
                    self.predict(_resize_seq(tiled, st, self.pad_value))
            else:
                self.predict(tiled)
        self.freeze_signatures()
        return self.signature_count()

    def freeze_signatures(self):
        """Mark the current signature set as the warm set for
        :meth:`assert_no_recompiles`."""
        with self._lock:
            self._warm_signatures = frozenset(self._signatures)

    def assert_no_recompiles(self):
        """Raise :class:`ServeError` if any call since
        :meth:`freeze_signatures` / :meth:`warmup` brought a new shape
        signature — the steady-state serving invariant."""
        if self._warm_signatures is None:
            raise ServeError("assert_no_recompiles called before warmup()")
        with self._lock:
            new = self._signatures - self._warm_signatures
        if new:
            raise ServeError(
                f"serve session {self.name!r} ran new shape signatures "
                f"after warmup: {sorted(new)!r}")

    def signature_count(self):
        with self._lock:
            return len(self._signatures)

    def cache_stats(self):
        """Signature-cache accounting, the counterpart of the JAX
        session's executable-cache stats: signatures seen, calls on a
        seen signature (hits) and calls that brought a new one
        (misses)."""
        with self._lock:
            return {"signatures": len(self._signatures),
                    "hits": self._hits, "misses": self._misses,
                    "warm": self._warm_signatures is not None}

    def stats(self):
        """Serving snapshot: the metrics, the signature cache, the breaker
        and watchdog-orphan accounting (abandoned execution bodies that
        may still be running — see ``resilience.retry.watchdog_orphans``)."""
        out = self.metrics.snapshot()
        out["signatures"] = self.signature_count()
        out["cache"] = self.cache_stats()
        out["breaker"] = self.breaker.snapshot()
        out["watchdog_orphans"] = watchdog_orphans()
        return out

    # -- hot swap -----------------------------------------------------------
    def _signature_matches(self, new_block):
        """True when ``new_block``'s parameters and buffers (count, names,
        shapes, dtypes, devices, ``requires_grad``, in order) are
        identical to the serving block's — the condition under which the
        new weights can be copied into the live tensors in place, so
        every signature (and every graph captured over those tensors)
        keeps serving them."""
        olds = _state_tensors(self.block)
        news = _state_tensors(new_block)
        if len(olds) != len(news):
            return False
        for (no, to), (nn_, tn) in zip(olds, news):
            if (no != nn_ or tuple(to.shape) != tuple(tn.shape)
                    or to.dtype != tn.dtype
                    or to.requires_grad != tn.requires_grad):
                return False
        return True

    def swap(self, new_block, example=None, timeout=30.0):
        """Hot-swap the served model: drain, switch, resume. Returns the
        swap mode.

        * ``"warm"`` — ``new_block`` has the serving block's parameter and
          buffer signature: its weights are copied into the live tensors
          in place, so every warm signature (and any CUDA graph captured
          over those tensors) keeps serving — :meth:`assert_no_recompiles`
          still holds afterwards.
        * ``"cold"`` — different architecture or shapes: ``new_block``
          replaces the old one and the signature set restarts; if
          ``example`` is given the full bucket lattice is re-warmed
          (through the internal admission bypass) before traffic resumes.

        Raises :class:`ServiceUnavailable` if the drain times out —
        admission is resumed so the old model keeps serving."""
        t0 = time.perf_counter()
        if not self.drain(timeout):
            self.resume()
            raise ServiceUnavailable(
                f"serve session {self.name!r}: swap aborted — in-flight "
                f"work did not settle within {timeout}s; still serving "
                "the old model")
        try:
            if self._signature_matches(new_block):
                mode = "warm"
                with torch.no_grad():
                    for (_, to), (_, tn) in zip(_state_tensors(self.block),
                                                _state_tensors(new_block)):
                        to.copy_(tn)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            else:
                mode = "cold"
                self.block = new_block
                self.device = _device.resolve(_block_device(new_block))
                with self._lock:
                    self._signatures = set()
                    self._warm_signatures = None
                if example is not None:
                    with _Flag(self._gate.bypass):
                        self.warmup(example)
        finally:
            self.resume()
        self.metrics.observe_swap(mode, time.perf_counter() - t0)
        return mode


class _Flag:
    """``with``-scope that sets ``local.on`` for the current thread."""

    __slots__ = ("_local", "_was")

    def __init__(self, local):
        self._local = local

    def __enter__(self):
        self._was = getattr(self._local, "on", False)
        self._local.on = True
        return self

    def __exit__(self, *exc):
        self._local.on = self._was
        return False


def _block_device(block):
    """Where a module's weights are: its parameters, or its buffers."""
    t = next(itertools.chain(block.parameters(), block.buffers()), None)
    return t.device if t is not None else None


def _state_tensors(block):
    """``[(name, tensor)]`` over a module's parameters then buffers."""
    return (list(block.named_parameters())
            + list(block.named_buffers()))


class _Captured:
    """One captured graph, the outputs it writes, and the kernel launches
    one replay of it makes, per counter."""

    __slots__ = ("graph", "outputs", "launches")

    def __init__(self, graph, outputs, launches):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches


class GraphSession(_Guarded):
    """One CUDA graph per signature key, captured at first use and replayed
    after (the port's counterpart of a compiled executable per signature),
    under the same protection stack as :class:`InferenceSession`: its own
    breaker, the ``serve:execute`` fault site and the watchdog around each
    replay, and the admission gate of ``owner`` (the session whose
    weights its graphs read), so draining the owner waits for replays in
    flight and refuses new ones.

    :meth:`run` takes a key and a body: a function of no arguments that
    reads the caller's static input tensors, writes whatever persistent
    state it owns in place, and returns its output tensors. On a CUDA
    device the first call with a key runs the body once eagerly on a side
    stream (so lazily built state — cuBLAS handles and workspaces, cached
    tables, a kernel library and its attributes — exists before capture),
    then captures it into a graph and replays it; every later call only
    replays. A capture runs on the calling thread, before the watchdog
    window; only the replay is watched. The caller refills the static
    inputs in place between calls. Captures run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a body that reads a
    device value on the host fails to capture, and a capture or replay
    error raises: nothing falls back to eager execution. On the CPU the
    body runs eagerly every call (inside the watchdog window), with the
    same signature accounting.

    ``counters`` are kernel modules with ``captured_count()`` and
    ``count_replays(n)`` (``ops.hopper.decode_attention``): a capture
    records how many launches each counter saw go into the graph, and
    each replay adds them, so launch counts stay what the card executed.

    All graphs of one session share a memory pool: they run one at a time
    on one stream, and each replay's outputs are read before the next
    replay, so one graph may reuse another's intermediate memory.
    Outputs are valid until the next :meth:`run`.

    Threads: a graph captured on one thread replays on any other (the
    continuous engine captures in ``warmup()`` on the caller's thread and
    replays on its scheduler thread). A replay runs on the calling
    thread's current stream (on the watchdog's thread, too), so the
    caller fills the static inputs on that same stream; a thread other
    than the capturing one must make the session's device current first
    (``torch.cuda.set_device``). Captures use
    ``capture_error_mode="thread_local"``, so work another thread runs
    during a capture cannot invalidate it; one thread at a time calls
    :meth:`run`.
    """

    def __init__(self, name, device, counters=(), owner=None):
        self.device = _device.resolve(device)
        self._counters = tuple(counters)
        self._graphs = {}
        self._signatures = set()
        self._warm_signatures = None
        self._captures = 0
        self._replays = 0
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()
        self._guard_init(name, gate=owner._gate if owner is not None
                         else None)

    @property
    def graphs(self):
        """True when the session captures and replays CUDA graphs."""
        return self.device.type == "cuda"

    def run(self, key, body):
        """Run the body for signature ``key`` under the protection stack:
        capture on first use, then replay (CUDA); or run it eagerly
        (CPU). Returns its outputs. Raises :class:`ServiceUnavailable`
        while the owner drains, the breaker is open, or a replay outlasts
        ``MXNET_SERVE_TIMEOUT_MS``."""
        cap = None

        def prepare():
            nonlocal cap
            with self._lock:
                self._signatures.add(key)
            if self.graphs:
                cap = self._graphs.get(key)
                if cap is None:
                    cap = self._graphs[key] = self._capture(body)

        def execute():
            if cap is None:
                return body()
            cap.graph.replay()
            self._replays += 1
            for counter, n in zip(self._counters, cap.launches):
                counter.count_replays(n)
            return cap.outputs

        return self._protected(execute, prepare)

    def _capture(self, body):
        torch.cuda.set_device(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        side, main = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            body()  # eager warm-up: real launches, counted as such
        main.wait_stream(side)
        before = [c.captured_count() for c in self._counters]
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
                graph, pool=self._pool, stream=side,
                capture_error_mode="thread_local"):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outputs = body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        self._captures += 1
        return _Captured(graph, outputs,
                         [c.captured_count() - n
                          for c, n in zip(self._counters, before)])

    def launches(self, key):
        """Kernel launches one replay of ``key``'s graph makes, per
        counter (``None`` before it is captured)."""
        cap = self._graphs.get(key)
        return None if cap is None else list(cap.launches)

    @property
    def captures(self):
        """Graphs captured so far."""
        return self._captures

    @property
    def replays(self):
        """Graph replays so far (a capture's own first replay included):
        one per host visit that ran a graph."""
        return self._replays

    # -- signature accounting (as InferenceSession) -------------------------
    def freeze_signatures(self):
        with self._lock:
            self._warm_signatures = frozenset(self._signatures)

    def assert_no_recompiles(self):
        """Raise :class:`ServeError` if any key was run (on a GPU:
        captured) since :meth:`freeze_signatures`."""
        if self._warm_signatures is None:
            raise ServeError("assert_no_recompiles called before warmup()")
        with self._lock:
            new = self._signatures - self._warm_signatures
        if new:
            raise ServeError(
                f"graph session {self.name!r} ran new signatures after "
                f"warmup: {sorted(new, key=repr)!r}")

    def signature_count(self):
        with self._lock:
            return len(self._signatures)


def _resize_seq(arr, st, pad_value):
    """Truncate or pad axis 1 of ``arr`` to exactly ``st`` positions."""
    if arr.shape[1] >= st:
        return arr[:, :st]
    seq_w = [(0, 0), (0, st - arr.shape[1])] + [(0, 0)] * (arr.ndim - 2)
    return _onp.pad(arr, seq_w, mode="constant", constant_values=pad_value)
