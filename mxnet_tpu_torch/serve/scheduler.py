"""Continuous batching: an iteration-level scheduler for the decode loop
(counterpart of ``mxnet_tpu/serve/scheduler.py``).

:class:`ContinuousEngine` batches at *iteration* granularity (Orca): the
decode loop runs over a fixed lattice of ``num_slots`` decode lanes, and
between any two decode visits it

* **retires** finished or expired slots — their futures settle at once
  (an expired request keeps its partial output on the 504), their KV
  pages recycle;
* **admits** queued requests into the freed slots straight from the
  :class:`~.batcher.DynamicBatcher` queue (``start=False``: the scheduler
  is the consumer), interactive-first, with the batcher's whole admission
  surface (deadlines, shedding, idempotency keys, 503/504 taxonomy);
* **prefills one chunk** of one admitted prompt at a fixed ``(1, chunk)``
  shape, round-robin across prefilling slots, so a long prompt never
  stalls live decodes for more than one chunk;
* **decodes** every live slot in ONE fixed-width visit: a ``(num_slots,
  1)`` step, or — ``multistep=True`` — a super-step of up to
  ``decode_steps`` iterations.

KV state lives in a :class:`~.kv_blocks.PagedKVPool`: per-layer page
pools plus a per-slot page table, gathered and scattered around the
unchanged model cache path. A request holds ``ceil((prompt + max_new) /
page_size)`` pages, reserved at admission, so it never dies mid-decode
from pool pressure; a full pool raises
:class:`~.engine.PoolExhausted` at admission and the request is requeued
at the front, never dropped.

Occupancy changes only rewrite page-table *values* and the token and
position vectors, never a shape. Idle and prefilling lanes get an
all-null table row (and ``remaining = 0`` in a super-step), so their
reads see the zeroed null page and their writes land there and are
re-zeroed; one shape serves every occupancy. On the GPU every decode
iteration of every layer runs the CUDA decode-attention kernel. Single
step: the ``(num_slots, 1)`` decode and the ``(1, chunk)`` prefill run
eagerly through an :class:`~.engine.InferenceSession`, as the
``Generator``'s single-step path does. Multi-step: each visit is one
replay of a CUDA graph keyed by (``num_slots``, N or 1, greedy or
sampled, kernel routes); :meth:`warmup` captures the four of the live
routes, the page table rides in the super-step's one packed input buffer,
and :meth:`assert_no_recompiles` holds across any admits and retires.

A graph has no early exit: where the JAX package's super-step leaves its
``while_loop`` once every lane is done, a visit here always runs all N
iterations (done lanes freeze, see ``generate._MultiStepForward``), and
:meth:`_steps_limit` chooses between the N-graph and the 1-graph. At most
N - 1 iterations of a visit are wasted, in a visit in which every live
lane finishes.

The ``baseline`` rung raises ``NotImplementedError``, as the port's
``Generator`` does. The int8 weight side table is the ``Generator``'s
``{id(weight): (int8, scale)}`` dict.
"""
from __future__ import annotations

import threading
import time

import numpy as _onp
import torch

from .. import config
from ..base import MXNetError
from ..profiler import attribution as _attr
from ..profiler import core as _prof
from ..profiler import trace as _trace
from ..resilience import faults as _faults
from .batcher import DynamicBatcher
from .engine import (DeadlineExceeded, GraphSession, InferenceSession,
                     PoolExhausted, ServeError, ServiceUnavailable)
from .generate import (_STOP_WIDTH, _CacheForward, _fresh_key_bits,
                       _graph_counters, _int8_weights_enabled,
                       _MultiStepForward,
                       _quantize_serving_weights, _replay_super,
                       _stop_matrix, _SuperInputs, resolve_decode_path,
                       sample_tokens)
from .kv_blocks import PagedKVPool
from .prefix_cache import PrefixCache


def _no_runner(_batch):  # pragma: no cover - the scheduler IS the consumer
    raise ServeError("continuous-batching queue has no flusher runner")


class _Slot:
    """One decode lane's live request state (scheduler-thread private)."""

    __slots__ = ("p", "prompt", "consumed", "pos", "decoding", "pending",
                 "tokens", "max_new", "temperature", "top_k", "stop",
                 "finished", "expired", "t_admit", "admit_wait_steps",
                 "ttft_ms", "decode_steps", "seed")

    def __init__(self, p, steps_now, seed=0):
        payload = p.payload
        self.p = p
        self.prompt = payload["prompt"]
        self.consumed = 0          # prompt tokens already prefilled
        self.pos = 0               # ring write position once decoding
        self.decoding = False      # prefill complete, pending token live
        self.pending = 0           # next token id to feed the decode step
        self.tokens = []           # emitted output ids
        self.max_new = payload["max_new"]
        self.temperature = payload["temperature"]
        self.top_k = payload["top_k"]
        self.stop = payload["stop"]
        self.finished = False
        self.expired = False
        self.t_admit = time.monotonic()
        self.admit_wait_steps = steps_now - payload["enq_step"]
        self.ttft_ms = None
        self.decode_steps = 0
        # per-request sampling-stream id (the engine's admission counter):
        # the super-step's sampler keys its draws by it, so two requests
        # reusing one slot never share a draw stream
        self.seed = int(seed)

    def emit(self, tid):
        """Account one sampled token; flips ``finished`` on stop/budget."""
        if tid in self.stop:
            self.finished = True
            return
        self.tokens.append(tid)
        if len(self.tokens) >= self.max_new:
            self.finished = True
        else:
            self.pending = tid


class ContinuousEngine:
    """Iteration-level scheduler + paged-KV decode loop for one model, on
    the model's device.

    Parameters
    ----------
    model : LlamaModel (the duck type :class:`~.generate.Generator`
        serves).
    max_seq : per-request logical ring length (prompt + generated tokens
        must fit); a whole number of KV pages.
    num_slots : decode lanes — the one decode width
        (``MXNET_SERVE_SLOTS`` default).
    page_size / num_pages : pool geometry (see
        :class:`~.kv_blocks.PagedKVPool`); undersize ``num_pages`` to
        oversubscribe — admission then queues on pool pressure.
    prefill_chunk : tokens prefilled per scheduler iteration at the fixed
        ``(1, chunk)`` shape (``MXNET_SERVE_PREFILL_CHUNK``; 0 means one
        KV page).
    decode_path : "pallas" or "int8" (see
        :func:`~.generate.resolve_decode_path`); "baseline" raises
        ``NotImplementedError``.
    prefix_cache : a radix trie over the pool (``None`` reads
        ``MXNET_SERVE_PREFIX_CACHE``): admission skips the matched
        prefix's prefill, clean retirements adopt their prompt pages.
    multistep / decode_steps : decode in super-steps of up to N
        iterations per visit (``None`` reads ``MXNET_SERVE_MULTISTEP`` /
        ``MXNET_SERVE_DECODE_STEPS``); CUDA graphs on a GPU.
    batcher_kwargs : extra :class:`~.batcher.DynamicBatcher` constructor
        overrides (``max_queue=``, ``timeout_ms=``, ...).
    """

    def __init__(self, model, max_seq=128, num_slots=None, page_size=None,
                 num_pages=None, prefill_chunk=None, pad_id=0,
                 name="llama_cb", decode_path=None, prefix_cache=None,
                 multistep=None, decode_steps=None, **batcher_kwargs):
        self.model = model
        self.device = next(model.parameters()).device
        self.max_seq = int(max_seq)
        if num_slots is None:
            num_slots = int(config.get("MXNET_SERVE_SLOTS"))
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ServeError(f"num_slots must be >= 1, got {num_slots}")
        self.pad_id = int(pad_id)
        self.decode_path = resolve_decode_path(decode_path)
        if self.decode_path == "baseline":
            raise NotImplementedError(
                "the strict 'baseline' decode rung is ported in a later "
                "slice of the serving port; use decode_path='pallas' or "
                "'int8'")
        self._quant = "int8" if self.decode_path == "int8" else None
        self._qweights = {}
        if self._quant and _int8_weights_enabled(self.device):
            self._qweights = _quantize_serving_weights(model)
        self.pool = PagedKVPool(model, self.num_slots, self.max_seq,
                                page_size=page_size, num_pages=num_pages,
                                quant=self._quant, device=self.device)
        if prefill_chunk is None:
            prefill_chunk = int(config.get("MXNET_SERVE_PREFILL_CHUNK"))
        self.prefill_chunk = (int(prefill_chunk) if prefill_chunk > 0
                              else self.pool.page_size)
        if self.prefill_chunk > self.max_seq:
            self.prefill_chunk = self.max_seq
        if prefix_cache is None:
            prefix_cache = bool(config.get("MXNET_SERVE_PREFIX_CACHE"))
        self.prefix = (PrefixCache(self.pool, name=f"{name}_prefix")
                       if prefix_cache else None)
        self._step_block = _CacheForward(
            model, self.max_seq, path=self.decode_path, quant=self._quant,
            quant_weights=self._qweights, paged=True)
        # the eager signatures: (1, chunk) chunked prefill and, single
        # step, the (num_slots, 1) decode
        self.session = InferenceSession(
            self._step_block,
            batch_buckets=tuple(sorted({1, self.num_slots})),
            seq_buckets=tuple(sorted({1, self.prefill_chunk})),
            pad_value=self.pad_id, name=name, device=self.device)
        self.metrics = self.session.metrics
        self.metrics.set_decode_path(self.decode_path)
        self.metrics.set_kv_cache_bytes(self.pool.nbytes())
        # the admission queue, flusher off: the scheduler consumes it via
        # take()/settle_one() between decode visits
        self._batcher = DynamicBatcher(
            _no_runner, start=False, max_batch_size=self.num_slots,
            name=f"{name}_queue", metrics=self.metrics, **batcher_kwargs)
        # decode critical-path ledger: observations are gated on
        # _attr.ENABLED; the ledger itself always exists
        self.ledger = _attr.Ledger(name)
        self._last_emit_t = None   # previous decode visit's token stamp
        self._slots = [None] * self.num_slots
        self._steps = 0            # completed scheduler iterations
        self._pf_next = 0          # round-robin cursor over prefill slots
        self._admit_wait_max = 0
        self._visits = 0           # decode visits (steps or super-steps)
        self._iterations = 0       # decode iterations run on the device
        self._thread = None
        self._stop = threading.Event()
        if multistep is None:
            multistep = bool(config.get("MXNET_SERVE_MULTISTEP"))
        self._multistep = bool(multistep)
        if decode_steps is None:
            decode_steps = int(config.get("MXNET_SERVE_DECODE_STEPS"))
        self.decode_steps = max(1, int(decode_steps))
        self._msession = None
        self._itl_est = None   # EMA seconds per decode iteration
        self._seed_seq = 0     # admission counter -> _Slot.seed
        if self._multistep:
            self._mstep = _MultiStepForward(
                model, self.max_seq, path=self.decode_path,
                quant=self._quant, quant_weights=self._qweights, paged=True)
            self._msession = GraphSession(
                f"{name}_multi", self.device,
                counters=_graph_counters(self._qweights), owner=self.session)
            self._inputs = _SuperInputs(self.num_slots,
                                        self.pool.pages_per_slot,
                                        self.decode_steps, self.device)
            # one key per engine; per-request streams come from each
            # slot's admission seed (and position) on the device
            self._key_bits = _fresh_key_bits()

    # -- admission -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, temperature=0.0,
               top_k=None, stop_ids=(), priority="interactive",
               deadline_ms=None, key=None):
        """Admit one generation request; returns a Future resolving to
        ``{"tokens": [...], "ttft_ms": ..., "admit_wait_steps": ...,
        "decode_steps": ...}``. The batcher's admission surface applies
        (priority classes, deadlines -> 504, queue caps/sheds -> 503,
        idempotency keys); a deadline that expires mid-decode settles
        with :class:`DeadlineExceeded` whose ``.partial`` carries the
        tokens generated so far."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("empty prompt (need >= 1 token)")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if len(prompt) + max_new > self.max_seq:
            raise MXNetError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds max_seq ({self.max_seq})")
        payload = {"prompt": prompt, "max_new": max_new,
                   "temperature": temperature, "top_k": top_k,
                   "stop": frozenset(int(s) for s in stop_ids),
                   "enq_step": self._steps}
        return self._batcher.submit(payload, priority=priority,
                                    deadline_ms=deadline_ms, key=key)

    # -- scheduler iteration -------------------------------------------------
    def _live(self):
        return [s for s in self._slots if s is not None]

    def _free_idx(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def _settle_slot(self, i, error=None):
        """Retire slot ``i``: settle its future, recycle its pages. On a
        clean retirement the prefix trie adopts the prompt's full pages
        first (increfs while the slot still pins them), so the next
        request sharing this prompt prefix skips that much prefill."""
        s = self._slots[i]
        self._slots[i] = None
        if self.prefix is not None and error is None and s.decoding:
            self.prefix.insert(s.prompt, self.pool.table()[i])
        self.pool.release(i)
        if error is not None:
            self._batcher.settle_one(s.p, error=error)
            return
        if s.expired:
            err = DeadlineExceeded(
                f"continuous engine {self.session.name!r}: deadline "
                f"expired after {len(s.tokens)} of {s.max_new} tokens")
            err.partial = list(s.tokens)
            self._batcher.settle_one(s.p, error=err)
            return
        n = len(s.tokens)
        self.metrics.observe_tokens(
            n, max(time.monotonic() - s.t_admit, 1e-9))
        self._batcher.settle_one(s.p, result={
            "tokens": list(s.tokens),
            "ttft_ms": s.ttft_ms,
            "admit_wait_steps": s.admit_wait_steps,
            "decode_steps": s.decode_steps,
        })

    def _retire(self):
        now = time.monotonic()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if not s.finished and s.p.deadline is not None \
                    and now >= s.p.deadline:
                # the request's budget ran out between visits: stop
                # burning decode work on output nobody will read
                s.finished = s.expired = True
                self.metrics.observe_deadline("decode", s.p.priority)
            if s.finished:
                self._settle_slot(i)

    def _admit(self):
        free = self._free_idx()
        while free:
            batch, sweep = self._batcher.take(1)
            if sweep:
                self._batcher.settle_expired(sweep)
                continue
            if not batch:
                return
            p = batch[0]
            i = free[0]
            need = len(p.payload["prompt"]) + p.payload["max_new"]
            matched, pages = 0, ()
            if self.prefix is not None:
                matched, pages = self.prefix.match(p.payload["prompt"])
            try:
                self._assign_with_reclaim(i, min(need, self.max_seq),
                                          pages)
            except PoolExhausted:
                # backpressure, not failure: the request keeps its place
                # at the queue front and is re-taken as pages recycle
                self._batcher.requeue(p)
                return
            free.pop(0)
            slot = _Slot(p, self._steps, seed=self._seed_seq)
            self._seed_seq += 1
            # a prefix hit: the matched pages already hold these tokens'
            # KV, so chunked prefill starts past them
            slot.consumed = matched
            self._slots[i] = slot
            if self.prefix is not None:
                self.metrics.observe_prefix(matched)
            if slot.admit_wait_steps > self._admit_wait_max:
                self._admit_wait_max = slot.admit_wait_steps

    def _assign_with_reclaim(self, i, budget, pages):
        """``assign_with_prefix`` with one eviction retry: on pool
        pressure the trie reclaims LRU cached prefixes (never the pages
        just matched, never pages a live slot references) before the
        PoolExhausted surfaces as backpressure."""
        try:
            return self.pool.assign_with_prefix(i, budget, pages)
        except PoolExhausted:
            if self.prefix is None:
                raise
            shortfall = (self.pool.pages_for(budget) - len(pages)
                         - self.pool.pages_free)
            if self.prefix.reclaim(max(shortfall, 1), exclude=pages) == 0:
                raise
            return self.pool.assign_with_prefix(i, budget, pages)

    def _run_step(self, tokens, start_pos, last_idx, table):
        """One eager paged step through the session: a (1, chunk)
        prefill chunk or the (num_slots, 1) decode. Returns the logits."""
        def dev(x):
            return torch.as_tensor(_onp.asarray(x, _onp.int32),
                                   device=self.device)

        out = self.session.run(dev(tokens), dev(start_pos), dev(last_idx),
                               dev(table), *self.pool.flat())
        self.pool.update_from_flat(out[1:])
        return out[0]

    def _prefill_once(self):
        """Advance ONE prefilling slot by one chunk (round-robin), at the
        fixed (1, chunk) shape. The final chunk samples the first token —
        that is the request's TTFT."""
        waiting = [i for i, s in enumerate(self._slots)
                   if s is not None and not s.decoding and not s.finished]
        if not waiting:
            return
        i = min(waiting, key=lambda j: (j - self._pf_next) % self.num_slots)
        self._pf_next = (i + 1) % self.num_slots
        s = self._slots[i]
        chunk = self.prefill_chunk
        piece = s.prompt[s.consumed:s.consumed + chunk]
        n = len(piece)
        toks = _onp.full((1, chunk), self.pad_id, _onp.int32)
        toks[0, :n] = piece
        table = self.pool.table()[i:i + 1]
        try:
            pf_args = {"slot": i, "n": n}
            with _attr.phase_scope("prefill"):
                p0_ns = time.perf_counter_ns()
                try:
                    logits = self._run_step(toks, [s.consumed], [n - 1],
                                            table)
                except Exception as e:
                    pf_args["error"] = type(e).__name__
                    raise
                finally:
                    self._span_fanout("serve::prefill_chunk", p0_ns,
                                      time.perf_counter_ns(), pf_args,
                                      (i,))
        except Exception as exc:  # pylint: disable=broad-except
            # only THIS slot was inside the failing call
            self._settle_slot(i, error=exc)
            return
        s.consumed += n
        if s.consumed < len(s.prompt):
            return
        # prompt fully written: sample the first token off the last real
        # position's logits (the Generator's step-0 sample)
        s.decoding = True
        s.pos = len(s.prompt)
        tid = int(sample_tokens(logits, temperature=s.temperature,
                                top_k=s.top_k)[0])
        s.ttft_ms = (time.monotonic() - s.p.t_enq) * 1e3
        self.metrics.observe_ttft(s.ttft_ms, s.p.priority)
        s.emit(tid)

    def _decode_once(self):
        """One fixed-width decode step over every decoding slot. Slots
        that are empty or still prefilling ride along as dead lanes:
        all-null page-table rows route their writes to the null page
        (re-zeroed by the scatter), so they can neither corrupt live
        state nor feed garbage back to themselves."""
        decoding = [i for i, s in enumerate(self._slots)
                    if s is not None and s.decoding and not s.finished]
        if not decoding:
            # idle gap, not a stall: no live token stream is waiting, so
            # the next decode step's ITL restarts from its own window
            self._last_emit_t = None
            return
        _faults.fault_point("serve:decode",
                            {"session": self.session.name})
        t_build = time.perf_counter()
        S = self.num_slots
        toks = _onp.zeros((S, 1), _onp.int32)
        pos = _onp.zeros(S, _onp.int32)
        table = _onp.zeros((S, self.pool.pages_per_slot), _onp.int32)
        live_table = self.pool.table()
        for i in decoding:
            s = self._slots[i]
            toks[i, 0] = s.pending
            pos[i] = s.pos
            table[i] = live_table[i]
        temps = [self._slots[i].temperature for i in decoding]
        # the visit's four-way attribution (host / dispatch / device /
        # wait partition the span wall; the input assembly above lands in
        # the ledger's schedule bucket): the span covers dispatch, the
        # blocking read of the sampled ids (the one sanctioned device
        # sync: its delta is the device phase) and the host bookkeeping
        attributing = _attr.ENABLED
        args = {"live": len(decoding)}
        with _attr.phase_scope("decode"):
            t1 = time.perf_counter()
            w1 = _attr.thread_wait_ns() if attributing else 0
            s0_ns = time.perf_counter_ns()
            try:
                logits = self._run_step(toks, pos,
                                        _onp.zeros(S, _onp.int32), table)
                self._visits += 1
                self._iterations += 1
                t2 = time.perf_counter()
                w2 = _attr.thread_wait_ns() if attributing else 0
                if all(t is None or t <= 0.0 for t in temps):
                    # one greedy argmax for all rows; blocks on the device
                    ids = sample_tokens(logits)
                    t3 = time.perf_counter()
                    w3 = _attr.thread_wait_ns() if attributing else 0
                    sampled = {i: int(ids[i]) for i in decoding}
                else:
                    arr = logits.to(torch.float32).cpu()  # blocking read
                    t3 = time.perf_counter()
                    w3 = _attr.thread_wait_ns() if attributing else 0
                    sampled = {}
                    for i in decoding:
                        s = self._slots[i]
                        sampled[i] = int(sample_tokens(
                            arr[i:i + 1], temperature=s.temperature,
                            top_k=s.top_k)[0])
                for i in decoding:
                    s = self._slots[i]
                    s.pos += 1
                    s.decode_steps += 1
                    s.emit(sampled[i])
                if attributing:
                    self._observe_visit(args, t_build, t1, t2, t3, w1, w2,
                                        w3, len(decoding))
            except Exception as e:
                args["error"] = type(e).__name__
                raise
            finally:
                self._span_fanout("serve::decode_step", s0_ns,
                                  time.perf_counter_ns(), args, decoding)
        # ITL is the token-to-token gap, not just the device window: in
        # steady state it runs from the PREVIOUS visit's emission, so
        # scheduler stalls between visits (admissions, prefill chunks, an
        # injected serve:decode delay) land in it. The first visit after
        # idle has no waiting stream; it falls back to its own window.
        prev = self._last_emit_t
        self._last_emit_t = t3
        itl_start = prev if prev is not None else t1
        self.metrics.observe_itl((t3 - itl_start) * 1e3,
                                 live=len(decoding))

    def _observe_visit(self, args, t_build, t1, t2, t3, w1, w2, w3, live,
                       tokens=None):
        """Land one decode visit's four-phase split in the span args and
        the ledger (attribution on)."""
        t4 = time.perf_counter()
        w4 = _attr.thread_wait_ns()
        dispatch_ms = max(0.0, (t2 - t1) * 1e3 - (w2 - w1) / 1e6)
        device_ms = (t3 - t2) * 1e3
        host_ms = max(0.0, (t4 - t3) * 1e3 - (w4 - w3) / 1e6)
        wait_ms = max(0.0, ((w2 - w1) + (w4 - w3)) / 1e6)
        args.update(host_ms=round(host_ms, 4),
                    dispatch_ms=round(dispatch_ms, 4),
                    device_ms=round(device_ms, 4),
                    wait_ms=round(wait_ms, 4))
        if tokens is not None:
            args["tokens"] = tokens
        self.ledger.observe_step(host_ms, dispatch_ms, device_ms, wait_ms,
                                 live=live, tokens=tokens)
        self.ledger.observe_schedule((t1 - t_build) * 1e3)

    def _run_multi(self, toks, pos, table, limit, remaining, seeds,
                   temps, top_ks, stops):
        """One super-step over the full slot lattice: one graph replay on
        a GPU (``generate._replay_super``). Returns ``(block, valid, done,
        t_dispatch, w_dispatch)``: the stamp pair is taken right after
        the replay is issued, before the blocking read, so
        :meth:`_decode_multi` can split dispatch from device time."""
        dispatched = []
        block, valid, done = _replay_super(
            self._msession, self._mstep, self._inputs, int(limit),
            self.pool.flat(),
            dict(tokens=toks, start_pos=pos, remaining=remaining,
                 seeds=seeds, temps=temps, top_ks=top_ks, stops=stops,
                 key_bits=self._key_bits, page_table=table),
            dispatched=dispatched)
        return block, valid, done, dispatched[0], _attr.thread_wait_ns()

    def _steps_limit(self, decoding):
        """The next super-step's iteration count: N, degraded to 1 when
        some live row's deadline could not survive a full N-iteration
        visit (per-iteration EMA estimate), so 504 retirement latency
        stays bounded by about one iteration. Both graphs are captured
        at warmup."""
        n = self.decode_steps
        if self._itl_est is None:
            return n
        now = time.monotonic()
        slack = min((self._slots[i].p.deadline - now for i in decoding
                     if self._slots[i].p.deadline is not None),
                    default=None)
        if slack is not None and slack < self._itl_est * n:
            return 1
        return n

    def _decode_multi(self):
        """One super-step over every decoding slot: ``_steps_limit()``
        decode iterations on the device, settled host-side in one pass by
        replaying :meth:`_Slot.emit` over each lane's valid token run.
        Dead and prefilling lanes ride along with ``remaining = 0`` and an
        all-null table row: done from iteration 0, their writes land on
        the (re-zeroed) null page. A visit runs all its iterations (no
        early exit on the device)."""
        decoding = [i for i, s in enumerate(self._slots)
                    if s is not None and s.decoding and not s.finished]
        if not decoding:
            self._last_emit_t = None
            return
        _faults.fault_point("serve:decode",
                            {"session": self._msession.name})
        t_build = time.perf_counter()
        S = self.num_slots
        toks = _onp.zeros((S, 1), _onp.int32)
        pos = _onp.zeros(S, _onp.int32)
        remaining = _onp.zeros(S, _onp.int32)
        seeds = _onp.zeros(S, _onp.int32)
        temps = _onp.zeros(S, _onp.float32)
        tks = _onp.zeros(S, _onp.int32)
        table = _onp.zeros((S, self.pool.pages_per_slot), _onp.int32)
        live_table = self.pool.table()
        stop_sets = [frozenset()] * S
        for i in decoding:
            s = self._slots[i]
            toks[i, 0] = s.pending
            pos[i] = s.pos
            remaining[i] = s.max_new - len(s.tokens)
            seeds[i] = s.seed
            temps[i] = (s.temperature if s.temperature is not None
                        and s.temperature > 0.0 else 0.0)
            tks[i] = int(s.top_k) if s.top_k else 0
            table[i] = live_table[i]
            stop_sets[i] = s.stop
        stops = _stop_matrix(S, stop_sets)
        limit = self._steps_limit(decoding)
        attributing = _attr.ENABLED
        args = {"live": len(decoding), "steps": limit}
        with _attr.phase_scope("decode"):
            t1 = time.perf_counter()
            w1 = _attr.thread_wait_ns() if attributing else 0
            s0_ns = time.perf_counter_ns()
            try:
                block, valid, _done, t2, w2 = self._run_multi(
                    toks, pos, table, limit, remaining, seeds, temps,
                    tks, stops)
                self._visits += 1
                self._iterations += limit   # a graph runs all of them
                t3 = time.perf_counter()
                w3 = _attr.thread_wait_ns() if attributing else 0
                # host settle: replay emit over each lane's token run —
                # the host stays the source of truth for stop/budget
                n_tok = 0
                steps_run = 0
                for i in decoding:
                    s = self._slots[i]
                    k = int(valid[i])
                    n_tok += k
                    if k > steps_run:
                        steps_run = k
                    s.pos += k
                    s.decode_steps += k
                    for j in range(k):
                        s.emit(int(block[i, j]))
                        if s.finished:
                            break
                if attributing:
                    self._observe_visit(args, t_build, t1, t2, t3, w1, w2,
                                        w3, len(decoding), tokens=n_tok)
            except Exception as e:
                args["error"] = type(e).__name__
                raise
            finally:
                self._span_fanout("serve::decode_step", s0_ns,
                                  time.perf_counter_ns(), args, decoding)
        prev = self._last_emit_t
        self._last_emit_t = t3
        itl_start = prev if prev is not None else t1
        if steps_run > 0:
            # the visit's wall amortizes over the iterations it ran —
            # k tokens means k consumer-visible gaps, not one giant one
            self.metrics.observe_itl((t3 - itl_start) * 1e3,
                                     live=len(decoding),
                                     tokens=steps_run)
            est = (t3 - t1) / steps_run
            self._itl_est = (est if self._itl_est is None
                             else 0.5 * self._itl_est + 0.5 * est)

    def _span_fanout(self, name, t0_ns, t1_ns, args, slot_idx):
        """Record one span into every listed slot's request trace — an
        iteration-level step is on EACH rider's critical path, and the
        engine thread has no ambient request trace to catch ``span()`` —
        plus the ambient trace when one IS active (inline ``step()``
        under an activated trace), never duplicating a target."""
        targets = []
        amb = _trace.current()
        if amb is not None:
            targets.append(amb)
        for i in slot_idx:
            s = self._slots[i]
            tr = s.p.trace if s is not None else None
            if tr is not None and tr not in targets:
                targets.append(tr)
        for tr in targets:
            tr.span_at(name, t0_ns, t1_ns, args)

    def step(self):
        """One scheduler iteration: retire -> admit -> one prefill chunk
        -> one decode visit -> gauges. Execution failures (an injected
        ``serve:execute`` or ``serve:decode`` fault) fail the requests
        that were inside the failing call; the scheduler keeps serving."""
        t0 = time.perf_counter()
        self._retire()
        self._admit()
        if _attr.ENABLED:
            # host-schedule: the admit/retire bookkeeping between visits
            self.ledger.observe_schedule((time.perf_counter() - t0) * 1e3)
        self._prefill_once()
        try:
            if self._multistep:
                self._decode_multi()
            else:
                self._decode_once()
        except Exception as exc:  # pylint: disable=broad-except
            for i, s in enumerate(self._slots):
                if s is not None and s.decoding:
                    self._settle_slot(i, error=exc)
        self._steps += 1
        self.metrics.set_kv_pages(self.pool.pages_used,
                                  self.pool.pages_free)
        self.metrics.set_slot_occupancy(len(self._live()), self.num_slots)
        if _attr.ENABLED:
            self.metrics.set_attribution(
                self.ledger.host_overhead_fraction(),
                self.ledger.device_ms_per_token())
        if self.prefix is not None:
            self.metrics.set_prefix_gauges(self.pool.pages_shared,
                                           self.prefix.pages_held,
                                           self.prefix.evictions)

    def _idle(self):
        return not self._live() and self._batcher.queue_depth() == 0

    def _run_loop(self):
        """The scheduler thread: makes the engine's device current and
        runs :meth:`step` under ``torch.inference_mode()`` (both are per
        thread) until :meth:`close`."""
        _prof.register_thread_name()
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                if self._idle():
                    with self._batcher._cond:
                        if not self._batcher._queue \
                                and not self._stop.is_set():
                            self._batcher._cond.wait(0.05)
                    continue
                self.step()

    # -- lifecycle -----------------------------------------------------------
    def warmup(self):
        """Run every live shape once and freeze the signature sets: one
        (1, chunk) prefill chunk plus — single step — one (num_slots, 1)
        decode step, or — multi-step — the super-step's graphs at N and
        1 iterations, greedy and sampled, on the live kernel routes
        (captured on a GPU). Every lane is dead here (null table rows,
        ``remaining = 0``), so warmup writes only the null page. Returns
        the signature count, the wall seconds and, multi-step, the graphs
        captured and their seconds."""
        t0 = time.perf_counter()
        n = self.pool.pages_per_slot
        S = self.num_slots
        out = {}
        self._run_step(
            _onp.zeros((1, self.prefill_chunk), _onp.int32), [0], [0],
            _onp.zeros((1, n), _onp.int32))
        if self._multistep:
            t1 = time.perf_counter()
            zeros = _onp.zeros(S, _onp.int32)
            for steps in sorted({self.decode_steps, 1}):
                for temp in (0.0, 1.0):
                    self._run_multi(
                        _onp.zeros((S, 1), _onp.int32), zeros,
                        _onp.zeros((S, n), _onp.int32), steps, zeros,
                        zeros, _onp.full(S, temp, _onp.float32), zeros,
                        _onp.full((S, _STOP_WIDTH), -1, _onp.int32))
            self._msession.freeze_signatures()
            out = {"captures": self._msession.captures,
                   "capture_s": time.perf_counter() - t1}
        else:
            self._run_step(
                _onp.zeros((S, 1), _onp.int32),
                _onp.zeros(S, _onp.int32), _onp.zeros(S, _onp.int32),
                _onp.zeros((S, n), _onp.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.session.freeze_signatures()
        sigs = self.session.signature_count()
        if self._msession is not None:
            sigs += self._msession.signature_count()
        return dict({"signatures": sigs,
                     "wall_s": time.perf_counter() - t0}, **out)

    def start(self):
        """Warm up (if not already) and start the scheduler thread."""
        if self.session._warm_signatures is None:
            self.warmup()
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True,
            name=f"mxtpu-serve-scheduler[{self.session.name}]")
        self._thread.start()

    def close(self, timeout=5.0):
        """Stop the scheduler thread, fail live slots and queued work
        with 503 (the batcher's close taxonomy), release every page."""
        self._stop.set()
        with self._batcher._cond:
            self._batcher._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for i, s in enumerate(self._slots):
            if s is not None:
                self._settle_slot(i, error=ServiceUnavailable(
                    f"continuous engine {self.session.name!r} shut down "
                    f"mid-request ({len(s.tokens)} tokens generated)"))
        self._batcher.close(timeout)

    def drain(self, timeout=30.0):
        """Stop admission and wait until every admitted request settles
        (queue empty AND all slots retired). :meth:`resume` reopens."""
        return self._batcher.drain(timeout)

    def resume(self):
        self._batcher.resume()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- invariants / readout ------------------------------------------------
    def assert_no_recompiles(self):
        """Raise if a shape signature (eager) or a graph (multi-step) is
        new since :meth:`warmup`."""
        self.session.assert_no_recompiles()
        if self._msession is not None:
            self._msession.assert_no_recompiles()

    def stats(self):
        out = self.session.stats()
        out["pool"] = self.pool.stats()
        out["steps"] = self._steps
        out["decode_visits"] = self._visits
        out["decode_iterations"] = self._iterations
        if self._msession is not None:
            out["multistep"] = {
                "signatures": self._msession.signature_count(),
                "captures": self._msession.captures}
            out["decode_steps"] = self.decode_steps
        out["slots_live"] = len(self._live())
        out["slots_total"] = self.num_slots
        out["admit_wait_steps_max"] = self._admit_wait_max
        out["queue_depth"] = self._batcher.queue_depth()
        out["duplicate_submits"] = self._batcher.duplicate_submits
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        return out
