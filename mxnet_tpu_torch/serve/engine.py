"""`InferenceSession`: bucketed serving executor (counterpart of
``mxnet_tpu/serve/engine.py``).

The session pads every call onto a small lattice of (batch, seq) buckets,
so steady-state traffic only ever runs shapes it has already seen. In the
JAX package each new shape is an XLA compile; PyTorch runs eagerly, so
here a shape signature is the unit a later CUDA-graph capture will key on.
The session keeps the set of signatures it has run, and
``assert_no_recompiles`` keeps its meaning: after ``warmup`` no call
brings a new signature.

Each session carries a :class:`~.metrics.ServeMetrics` (``metrics``,
``stats()``), runs the ``serve:execute`` fault site before every call and
records a ``serve::session_run(<name>)`` span on the calling thread's
ambient request trace. The JAX session's circuit breaker and execution
watchdog are not ported yet.

:class:`GraphSession` is the counterpart of the compiled executables the
JAX package keeps per signature: on a GPU it captures one CUDA graph per
signature key and replays it, with the same signature accounting.
"""
from __future__ import annotations

import itertools
import threading

import numpy as _onp
import torch

from .. import device as _device
from ..base import MXNetError
from ..profiler import trace as _trace
from ..resilience import faults as _faults
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


class InferenceSession:
    """Bucketed executor for one module.

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
        self.name = name or type(block).__name__
        if device is None:  # where the weights are: parameters or buffers
            param = next(itertools.chain(block.parameters(), block.buffers()),
                         None)
            device = param.device if param is not None else None
        self.device = _device.resolve(device)
        self.metrics = ServeMetrics(self.name)
        self._signatures = set()
        self._warm_signatures = None
        self._lock = threading.Lock()

    def run(self, *args):
        """Execute one already-bucketed call under
        ``torch.inference_mode()``, recording its shape signature. The
        ``serve:execute`` fault site fires first; a failure propagates
        unchanged (a batcher or the continuous engine maps it onto the
        requests inside the call)."""
        sig = _signature(args)
        with self._lock:
            self._signatures.add(sig)
        with _trace.span(f"serve::session_run({self.name})"):
            _faults.fault_point("serve:execute", {"session": self.name})
            with torch.inference_mode():
                return self.block(*args)

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
        the signature set. Returns the signature count."""
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

    def stats(self):
        """Serving snapshot: the metrics plus the signature count."""
        out = self.metrics.snapshot()
        out["signatures"] = self.signature_count()
        return out


class _Captured:
    """One captured graph, the outputs it writes, and the kernel launches
    one replay of it makes, per counter."""

    __slots__ = ("graph", "outputs", "launches")

    def __init__(self, graph, outputs, launches):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches


class GraphSession:
    """One CUDA graph per signature key, captured at first use and replayed
    after (the port's counterpart of a compiled executable per signature).

    :meth:`run` takes a key and a body: a function of no arguments that
    reads the caller's static input tensors, writes whatever persistent
    state it owns in place, and returns its output tensors. On a CUDA
    device the first call with a key runs the body once eagerly on a side
    stream (so lazily built state — cuBLAS handles and workspaces, cached
    tables, a kernel library and its attributes — exists before capture),
    then captures it into a graph and replays it; every later call only
    replays. The caller refills the static inputs in place between calls.
    Captures run under ``torch.cuda.set_sync_debug_mode("error")``, so a
    body that reads a device value on the host fails to capture, and a
    capture or replay error raises: nothing falls back to eager execution.
    On the CPU the body runs eagerly every call, with the same signature
    accounting.

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
    thread's current stream, so the caller fills the static inputs on
    that same stream; a thread other than the capturing one must make the
    session's device current first (``torch.cuda.set_device``). Captures
    use ``capture_error_mode="thread_local"``, so work another thread
    runs during a capture cannot invalidate it; one thread at a time
    calls :meth:`run`.
    """

    def __init__(self, name, device, counters=()):
        self.name = name
        self.device = _device.resolve(device)
        self._counters = tuple(counters)
        self._graphs = {}
        self._signatures = set()
        self._warm_signatures = None
        self._captures = 0
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()

    @property
    def graphs(self):
        """True when the session captures and replays CUDA graphs."""
        return self.device.type == "cuda"

    def run(self, key, body):
        """Run the body for signature ``key``: capture on first use, then
        replay (CUDA); or run it eagerly (CPU). Returns its outputs."""
        with self._lock:
            self._signatures.add(key)
        if not self.graphs:
            with torch.inference_mode():
                return body()
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(body)
        cap.graph.replay()
        for counter, n in zip(self._counters, cap.launches):
            counter.count_replays(n)
        return cap.outputs

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
