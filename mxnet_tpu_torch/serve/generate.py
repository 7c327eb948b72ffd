"""Autoregressive decode with a real KV cache (counterpart of
``mxnet_tpu/serve/generate.py``).

:class:`KVCache` preallocates per-layer K/V rings to ``max_seq`` on the
model's device and the decode step feeds exactly one new token through the
model's cache path, so each generated token costs one T = 1 pass. Every
decode step of every layer runs its attention through the hand-written
CUDA decode-attention kernel (``ops/hopper/decode_attention``) on the GPU;
prefill (T = prompt bucket) runs its plain PyTorch version, as the JAX
package routes T > 1 to ``_xla_decode``. On the ``int8`` rung with int8
weights (``MXNET_SERVE_DECODE_INT8_WEIGHTS``; ``auto`` is on for a model
on the GPU) every projection and the LM head, prefill and decode, run the
int8 x int8 kernel (``ops/hopper/int8_dense``) on per-channel int8
weights quantized once when the Generator is built.

Shapes are bucketed the serving way: one decode signature per batch
bucket, one prefill signature per (batch, prompt) bucket; after
:meth:`Generator.warmup` a decode stream of any admitted shape brings no
new signature.

Options, as in the JAX package: ``paged=`` backs the KV state with a
:class:`~.kv_blocks.PagedKVPool` per batch bucket, ``prefix_cache=`` adds
a radix trie (:class:`~.prefix_cache.PrefixCache`) over it, and
``multistep=`` runs the token loop as super-steps of up to
``decode_steps`` iterations per host visit (:class:`_MultiStepForward`):
on a GPU each super-step is one replay of a CUDA graph captured per batch
bucket, with sampling and stop/budget checks on the device and one
(B, N) token block read back per visit. The strict ``baseline`` rung
raises ``NotImplementedError`` until its slice lands.

:class:`SpeculativeGenerator` pairs a target ``Generator`` with a draft
one: the draft proposes k tokens a round (with ``multistep`` its k+1
iterations are one super-step replay), and the target scores the whole
(k+1)-token block in one verify pass — one CUDA-graph replay per batch
bucket on a GPU — so a round costs two host visits.
"""
from __future__ import annotations

import time

import numpy as _onp
import torch
from torch import nn

from .. import config
from .. import random as _rng
from ..base import MXNetError
from ..ops import nn as _ops
from ..ops.hopper import decode_attention as _da
from ..ops.hopper import int8_dense as _i8
from ..ops.nn import int8_scale
from ..profiler import trace as _trace
from ..resilience import faults as _faults
from .engine import GraphSession, InferenceSession, PoolExhausted, \
    pick_bucket


class _LayerKV:
    """One layer's view of the cache: read k/v (plus int8 scale rings when
    quantized) and record the updated rings."""

    __slots__ = ("_cache", "_idx")

    def __init__(self, cache, idx):
        self._cache = cache
        self._idx = idx

    @property
    def k(self):
        return self._cache._k[self._idx]

    @property
    def v(self):
        return self._cache._v[self._idx]

    @property
    def k_scale(self):
        return self._cache._ks[self._idx]

    @property
    def v_scale(self):
        return self._cache._vs[self._idx]

    @property
    def max_seq(self):
        return self._cache.max_seq

    @property
    def quant(self):
        return self._cache.quant

    @property
    def path(self):
        return self._cache.path

    @property
    def quant_weights(self):
        return self._cache.quant_weights

    def update(self, new_k, new_v, new_k_scale=None, new_v_scale=None):
        self._cache._k[self._idx] = new_k
        self._cache._v[self._idx] = new_v
        if new_k_scale is not None:
            self._cache._ks[self._idx] = new_k_scale
        if new_v_scale is not None:
            self._cache._vs[self._idx] = new_v_scale


class KVCache:
    """Preallocated per-layer K/V rings for autoregressive decode.

    Layout: ``num_layers`` pairs of (batch, kv_heads, max_seq, head_dim)
    tensors, zero-initialized. With ``quant="int8"`` the rings are int8
    and each carries a (batch, kv_heads, max_seq) f32 scale ring
    (per-token-per-head symmetric quantization, written by
    ``ops.nn.kv_cache_write_q``) — about a quarter of the f32 rings' bytes.
    Position accounting lives with the caller (per-row ``start_pos``
    vectors); the cache itself is pure storage. The serving ops write the
    rings in place.

    ``path`` / ``quant_weights`` are routing attributes set by the serving
    step before the model forward: which ``cached_attention`` formulation
    the layers run, and (int8 rung) the ``{id(weight): (int8_weight,
    scale)}`` side table for ``ops.nn.quantized_dense``.
    """

    def __init__(self, keys, values, max_seq, key_scales=None,
                 value_scales=None, quant=None):
        if len(keys) != len(values):
            raise MXNetError("KVCache needs one value ring per key ring")
        self._k = list(keys)
        self._v = list(values)
        self._ks = list(key_scales) if key_scales is not None else None
        self._vs = list(value_scales) if value_scales is not None else None
        if quant is not None and (self._ks is None or self._vs is None):
            raise MXNetError("quantized KVCache needs scale rings")
        self.quant = quant
        self.max_seq = int(max_seq)
        self.path = "pallas"
        self.quant_weights = None

    @classmethod
    def alloc(cls, model, batch, max_seq, dtype="float32", quant=None,
              device=None):
        """Zeroed rings sized from the model's attention geometry, on
        ``device`` (default: the model's)."""
        if device is None:
            device = next(model.parameters()).device
        keys, values = [], []
        kscales, vscales = [], []
        for blk in model._blocks:
            attn = blk.attention
            shape = (int(batch), attn._kv_heads, int(max_seq),
                     attn._head_dim)
            if quant == "int8":
                keys.append(torch.zeros(shape, dtype=torch.int8,
                                        device=device))
                values.append(torch.zeros(shape, dtype=torch.int8,
                                          device=device))
                kscales.append(torch.zeros(shape[:3], dtype=torch.float32,
                                           device=device))
                vscales.append(torch.zeros(shape[:3], dtype=torch.float32,
                                           device=device))
            elif quant is None:
                keys.append(torch.zeros(shape, dtype=getattr(torch, dtype),
                                        device=device))
                values.append(torch.zeros(shape, dtype=getattr(torch, dtype),
                                          device=device))
            else:
                raise MXNetError(f"unknown KVCache quant {quant!r}")
        if quant is None:
            return cls(keys, values, max_seq)
        return cls(keys, values, max_seq, kscales, vscales, quant)

    @property
    def num_layers(self):
        return len(self._k)

    @property
    def batch(self):
        return self._k[0].shape[0]

    def layer(self, i) -> _LayerKV:
        return _LayerKV(self, i)

    def flat(self):
        """Interleaved [k0, v0, k1, v1, ...] — the serving step's calling
        convention for cache state. Quantized caches interleave
        [k0, ks0, v0, vs0, ...] (scale ring right after its int8 ring)."""
        out = []
        if self.quant is not None:
            for k, ks, v, vs in zip(self._k, self._ks, self._v, self._vs):
                out.extend((k, ks, v, vs))
            return out
        for k, v in zip(self._k, self._v):
            out.extend((k, v))
        return out

    @classmethod
    def from_flat(cls, arrays, max_seq, quant=None):
        arrays = list(arrays)
        if quant is not None:
            if len(arrays) % 4:
                raise MXNetError(
                    "flat quantized KVCache needs 4 arrays per layer")
            return cls(arrays[0::4], arrays[2::4], max_seq,
                       arrays[1::4], arrays[3::4], quant)
        if len(arrays) % 2:
            raise MXNetError("flat KVCache needs an even array count")
        return cls(arrays[0::2], arrays[1::2], max_seq)

    def nbytes(self):
        arrays = self._k + self._v
        if self.quant is not None:
            arrays = arrays + self._ks + self._vs
        return sum(a.numel() * a.element_size() for a in arrays)


class _CacheForward(nn.Module):
    """The serving step: (tokens, start_pos, last_idx, *rings) ->
    (last-position logits, *rings).

    One forward serves both phases — prefill (T = prompt bucket,
    start_pos = 0, last_idx = prompt_len - 1) and decode (T = 1,
    start_pos = per-row position, last_idx = 0). The rings are written in
    place and returned for the calling convention's sake. The int8 weight
    side table is held here: the JAX package threads it through its
    compiled step as two packed call arguments, which eager PyTorch does
    not need.

    ``paged=True`` switches the cache-state convention from rings to page
    pools: the call grows a ``page_table`` (B, N) argument after
    ``last_idx``, the per-layer tensors are (P, KV, page, D) pools, and the
    step brackets the UNCHANGED model cache path with
    ``ops.nn.paged_kv_gather`` (pool -> per-slot ring) and
    ``ops.nn.paged_kv_scatter`` (the T freshly written rows -> pool, in
    place), as the JAX package's fast rungs do.

    ``all_logits=True`` (the speculative verify step) returns the logits
    of every position, (B, T, vocab), and ignores ``last_idx``.
    """

    def __init__(self, model, max_seq, path="pallas", quant=None,
                 quant_weights=None, all_logits=False, paged=False):
        super().__init__()
        self.model = model
        self._max_seq = int(max_seq)
        self._path = path
        self._quant = quant
        self._quant_weights = quant_weights or None
        self._all_logits = bool(all_logits)
        self._paged = bool(paged)

    def forward(self, tokens, start_pos, last_idx, *rest):
        flat_cache = rest
        if self._paged:
            page_table, pools = rest[0], rest[1:]
            flat_cache = [_ops.paged_kv_gather(p, page_table) for p in pools]
        cache = KVCache.from_flat(flat_cache, self._max_seq,
                                  quant=self._quant)
        cache.path = self._path
        cache.quant_weights = self._quant_weights
        last = self.model(tokens, cache=cache, start_pos=start_pos,
                          last_idx=None if self._all_logits else last_idx)
        if self._paged:
            t_len = tokens.shape[1]
            return (last,) + tuple(
                _ops.paged_kv_scatter(p, page_table, r, start_pos, t_len)
                for p, r in zip(pools, cache.flat()))
        return (last,) + tuple(cache.flat())


def sample_tokens(logits, temperature=0.0, top_k=None):
    """Next-token choice from (B, vocab) logits.

    ``temperature <= 0`` is greedy argmax (ties go to the lowest id, as in
    the JAX package); otherwise softmax sampling at the given temperature,
    optionally truncated to the ``top_k`` largest logits, drawn from the
    logits' device stream of ``mxnet_tpu_torch.random`` — reproducible
    under ``random.seed(n)``, but not the JAX package's threefry bits.
    Returns a host numpy (B,) int32 array.
    """
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    scaled = logits.to(torch.float32) / float(temperature)
    if top_k is not None and 0 < int(top_k) < scaled.shape[-1]:
        kth = torch.topk(scaled, int(top_k), dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth,
                             torch.tensor(float("-inf"), device=scaled.device),
                             scaled)
    probs = torch.softmax(scaled, dim=-1)
    ids = torch.multinomial(probs, 1,
                            generator=_rng.generator(logits.device))[:, 0]
    return ids.to(torch.int32).cpu().numpy()


# stop-token matrix width of the multi-step super-step: per-lane stop
# sets are padded/truncated to this many int32 entries (-1 = unused).
# Requests with more stop ids than this still stop correctly — the host
# settle checks the FULL stop set — the device loop just cannot freeze the
# lane early on the overflowed ids (extra iterations, never wrong output).
_STOP_WIDTH = 8


def _stop_matrix(rows, stop_sets):
    """(rows, _STOP_WIDTH) int32 stop matrix, padded with -1."""
    m = _onp.full((rows, _STOP_WIDTH), -1, _onp.int32)
    for i, st in enumerate(stop_sets):
        ids = sorted(int(t) for t in st)[:_STOP_WIDTH]
        m[i, :len(ids)] = ids
    return m


def _fresh_key_bits():
    """(2,) uint32 base key of a sampled super-step stream, drawn from
    ``mxnet_tpu_torch.random``'s seeded host stream (see
    ``ops.nn.sample_step``): reproducible under ``random.seed(n)``."""
    gen = _rng.generator("cpu")
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=gen).numpy().astype(_onp.uint32)


class _MultiStepForward(nn.Module):
    """The decode super-step: ``steps`` decode iterations in one call,
    which a GPU Generator captures as one CUDA graph per (batch bucket,
    steps, sampled, routing) and replays once per host visit.

    Calling convention::

        (tokens (S,1), start_pos (S,), remaining (S,), seeds (S,),
         temps (S,), top_ks (S,), stops (S, _STOP_WIDTH), key_bits (2,),
         page_table (S,P) or None, *rings or *pools, steps=, sampled=)
        -> (S, steps + 2) int32: the token block, then per lane the count
           of valid tokens and the done flag

    Each iteration feeds each lane's pending token through the UNCHANGED
    model cache path (the single-step decode's layers and kernels, the
    decode-attention kernel in every layer), picks the successor on the
    device (argmax, or ``ops.nn.sample_step`` when ``sampled``), records
    it in the block, and advances. The JAX package's loop is a
    ``lax.while_loop`` with a traced ``steps_limit`` that exits as soon as
    every lane is done; a graph has no early exit, so ``steps`` is static
    (the host asks for N or 1) and a visit always runs all of its
    iterations. The waste is bounded: at most N - 1 iterations of a
    generate's last visit (1 of 32 at 32 tokens and N = 8).

    Finished lanes FREEZE instead of masking, as in the JAX package: a lane
    that hit a stop id or its token budget (``remaining``) stops advancing
    (token, position), so each further iteration recomputes and rewrites
    byte-identical K/V at its frozen position. Lanes with ``remaining``
    0 (padding lanes, stopped rows) are done from the start.

    Paged mode hoists the brackets, as the JAX package does: ONE
    ``paged_kv_gather`` before the loop, ONE ``paged_kv_scatter`` of
    ``steps`` rows after it. Rows past a lane's write extent scatter back
    the bytes the gather produced, and positions past its pages land on
    the null page, which the scatter re-zeroes.

    Nothing here reads a device value on the host, so the whole body
    captures into a graph.
    """

    def __init__(self, model, max_seq, path="pallas", quant=None,
                 quant_weights=None, paged=False):
        super().__init__()
        self.model = model
        self._max_seq = int(max_seq)
        self._path = path
        self._quant = quant
        self._quant_weights = quant_weights or None
        self._paged = bool(paged)

    def forward(self, tokens, start_pos, remaining, seeds, temps, top_ks,
                stops, key_bits, page_table, *flat, steps, sampled):
        rings = list(flat)
        if self._paged:
            pools = rings
            rings = [_ops.paged_kv_gather(p, page_table) for p in pools]
        lanes = tokens.shape[0]
        last_idx = torch.zeros(lanes, dtype=torch.int32,
                               device=tokens.device)
        cur, pos = tokens, start_pos
        done = remaining <= 0
        emitted = torch.zeros_like(remaining)
        cols = []
        for _ in range(int(steps)):
            cache = KVCache.from_flat(rings, self._max_seq,
                                      quant=self._quant)
            cache.path = self._path
            cache.quant_weights = self._quant_weights
            logits = self.model(cur, cache=cache, start_pos=pos,
                                last_idx=last_idx)
            if sampled:
                nxt = _ops.sample_step(logits, temps, top_ks, seeds, pos,
                                       key_bits)
            else:  # sample_step's greedy branch, without the sampled one
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            active = ~done
            cols.append(torch.where(active, nxt, -1))
            emitted = emitted + active.to(torch.int32)
            is_stop = torch.any(stops == nxt[:, None], dim=1)
            done = done | (active & is_stop) | (emitted >= remaining)
            # advance only lanes still alive AFTER this emission: newly
            # finished lanes freeze at their last written position
            adv = active & ~done
            cur = torch.where(adv[:, None], nxt[:, None], cur)
            pos = torch.where(adv, pos + 1, pos)
        if self._paged:
            for p, r in zip(pools, rings):
                _ops.paged_kv_scatter(p, page_table, r, start_pos, steps)
        return torch.cat([torch.stack(cols, dim=1), emitted[:, None],
                          done[:, None].to(torch.int32)], dim=1)


class _StaticInputs:
    """Static input buffers of one captured body: every input packed into
    one int32 buffer (float inputs as their bits), so a visit fills a host
    copy and moves it to the device in ONE copy, and an int32 output comes
    back in one copy. On a GPU the host side is pinned and the device side
    is what the graphs were captured on; on the CPU both sides are one
    buffer. ``sizes`` lists (name, element count) in buffer order."""

    def __init__(self, sizes, out_numel, device):
        self._slices, off = {}, 0
        for name, n in sizes:
            self._slices[name] = (off, off + n)
            off += n
        cuda = device.type == "cuda"
        self.host = torch.zeros(off, dtype=torch.int32, pin_memory=cuda)
        self.dev = (torch.zeros(off, dtype=torch.int32, device=device)
                    if cuda else self.host)
        self.out_host = torch.zeros(out_numel, dtype=torch.int32,
                                    pin_memory=cuda)

    def _view(self, name):
        a, b = self._slices[name]
        return self.dev[a:b]

    def fill(self, **arrays):
        """Write host arrays into the host buffer and, on a GPU, start its
        one copy to the device (ordered before the replay on the
        stream)."""
        h = self.host.numpy()
        for name, x in arrays.items():
            a, b = self._slices[name]
            if name == "temps":
                h[a:b].view(_onp.float32)[:] = _onp.asarray(
                    x, _onp.float32).reshape(-1)
            else:
                h[a:b] = _onp.asarray(x).astype(_onp.int64).reshape(
                    -1).astype(_onp.uint32).view(_onp.int32)
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)

    def read(self, out):
        """An int32 output tensor as host numpy, in one copy."""
        if not out.is_cuda:
            return out.numpy().copy()
        host = self.out_host[:out.numel()].view(out.shape)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        return host.numpy().copy()


class _SuperInputs(_StaticInputs):
    """The static buffers of one batch bucket's super-step
    (``_MultiStepForward``'s inputs; ``temps`` as float32 bits, the key as
    two 32-bit words) and its (S, steps + 2) output block."""

    def __init__(self, lanes, pages, steps, device):
        self.lanes, self.pages = int(lanes), int(pages)
        super().__init__(
            [("tokens", lanes), ("start_pos", lanes), ("remaining", lanes),
             ("seeds", lanes), ("temps", lanes), ("top_ks", lanes),
             ("stops", lanes * _STOP_WIDTH), ("key_bits", 2),
             ("page_table", lanes * pages)],
            lanes * (steps + 2), device)

    def views(self):
        """The device-side inputs in ``_MultiStepForward``'s order."""
        v, s = self._view, self.lanes
        return (v("tokens").view(s, 1), v("start_pos"), v("remaining"),
                v("seeds"), v("temps").view(torch.float32), v("top_ks"),
                v("stops").view(s, _STOP_WIDTH), v("key_bits"),
                v("page_table").view(s, self.pages) if self.pages else None)


class _VerifyInputs(_StaticInputs):
    """The static buffers of one batch bucket's speculative verify pass:
    the (B, k+1) token block, per-row ``start_pos``, a zero ``last_idx``
    (the calling convention's; ``all_logits`` ignores it) and, paged, the
    (B, P) page table; the (B, k+1) greedy ids come back in one copy."""

    def __init__(self, lanes, width, pages, device):
        self.lanes, self.width, self.pages = int(lanes), int(width), \
            int(pages)
        super().__init__(
            [("tokens", lanes * width), ("start_pos", lanes),
             ("last_idx", lanes), ("page_table", lanes * pages)],
            lanes * width, device)

    def views(self):
        """``(tokens, start_pos, last_idx[, page_table])`` on the
        device."""
        v = self._view
        out = (v("tokens").view(self.lanes, self.width), v("start_pos"),
               v("last_idx"))
        if self.pages:
            out += (v("page_table").view(self.lanes, self.pages),)
        return out


def _graph_counters(qweights):
    """The kernel modules whose launches a serving :class:`GraphSession`
    counts at its replays: the decode attention, and the int8 product
    where the projections run on pre-quantized weights (``qweights``)."""
    return (_da, _i8) if qweights else (_da,)


def _graph_route():
    """The routing a captured graph keeps, for its key: the decode
    attention's override and the int8 product's."""
    return _da.forced_path(), _i8.forced_path()


def _replay_super(session, step, inp, steps, flat, arrays, events=None,
                  dispatched=None):
    """The host side of one super-step visit, shared by a
    :class:`Generator`'s batch bucket and the continuous engine's slot
    lattice: write the host ``arrays`` (``_SuperInputs.fill``'s names)
    into the lattice's static buffers ``inp`` and move them to the device
    in one copy, replay the graph of (lanes, ``steps``, greedy or sampled,
    kernel routes) in the :class:`GraphSession` — capturing it first on
    its first use — and read the (lanes, steps + 2) block back in one
    copy. A visit is sampled when any lane's temperature is above 0; greedy
    lanes of a sampled visit still take argmax (``ops.nn.sample_step``).
    ``flat`` is the cache state the body reads and writes in place.

    Returns host numpy ``(block, valid, done)``: the (lanes, steps) token
    block (-1 where a lane was done), per-lane valid counts and done flags.

    ``events``: optional list; on a GPU one (start, end) pair of CUDA
    events recorded around the replay is appended (its device time).
    ``dispatched``: optional list; the host clock right after the replay
    was issued, before the blocking read, is appended."""
    sampled = bool((_onp.asarray(arrays["temps"], _onp.float32) > 0).any())
    inp.fill(**arrays)

    def body():
        return step(*inp.views(), *flat, steps=steps, sampled=sampled)

    timed = events is not None and session.graphs
    if timed:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    out = session.run((inp.lanes, steps, sampled, _graph_route()), body)
    if timed:
        e1.record()
        events.append((e0, e1))
    if dispatched is not None:
        dispatched.append(time.perf_counter())
    packed = inp.read(out)
    return packed[:, :steps], packed[:, steps], packed[:, steps + 1]


_DECODE_PATHS = ("baseline", "pallas", "int8")


def resolve_decode_path(decode_path=None):
    """The decode rung a Generator runs. ``MXNET_SERVE_STRICT_PARITY``
    pins "baseline" over everything; otherwise an explicit ``decode_path``
    argument wins over the ``MXNET_SERVE_DECODE_PATH`` flag, and "auto"
    means the fused-kernel "pallas" rung (the name is the JAX package's;
    here it runs the CUDA kernel)."""
    if config.get("MXNET_SERVE_STRICT_PARITY"):
        return "baseline"
    path = decode_path
    if path is None:
        path = config.get("MXNET_SERVE_DECODE_PATH")
    if path in (None, "auto"):
        path = "pallas"
    if path not in _DECODE_PATHS:
        raise MXNetError(
            f"decode_path {path!r} not in {_DECODE_PATHS} "
            "(speculative decoding is serve.SpeculativeGenerator, not a "
            "KV-cache path)")
    return path


def _int8_weights_enabled(device):
    """Resolve MXNET_SERVE_DECODE_INT8_WEIGHTS for the int8 rung on a model
    that lives on ``device``. "auto" is on for a CUDA device, whose tensor
    cores run ``quantized_dense``'s int8 x int8 kernel, and off on the CPU,
    where ``quantized_dense`` dequantizes the weight to f32 (as the JAX
    package turns it on for backends with int8 matrix units only). "1" and
    "0" force it on and off."""
    flag = str(config.get("MXNET_SERVE_DECODE_INT8_WEIGHTS")).strip().lower()
    if flag == "auto":
        return torch.device(device).type == "cuda"
    return flag in ("1", "true", "yes", "on")


def _quantize_serving_weights(model):
    """Pre-quantize the model's serving projections to per-output-channel
    int8 for ``ops.nn.quantized_dense``, on the model's device: returns
    ``{id(weight): (int8 weight, f32 scale)}`` (the JAX package packs the
    same entries into two flat arrays for its compiled step). Models
    without the llama projection layout get an empty table: int8 KV rings
    only."""
    try:
        weights = []
        for blk in model._blocks:
            attn, ffn = blk.attention, blk.ffn
            weights += [attn.q_proj.weight, attn.k_proj.weight,
                        attn.v_proj.weight, attn.o_proj.weight,
                        ffn.gate_proj.weight, ffn.up_proj.weight,
                        ffn.down_proj.weight]
        weights.append(model.embed.weight if model._tie
                       else model.lm_head.weight)
    except AttributeError:
        return {}
    table = {}
    with torch.no_grad():
        for w in weights:
            scale = int8_scale(torch.abs(w).amax(dim=1))
            qw = torch.clamp(torch.round(w / scale[:, None]),
                             -127, 127).to(torch.int8)
            table[id(w)] = (qw, scale)
    return table


class Generator:
    """Bucketed KV-cache generation server for decoder LMs.

    Wraps the model into a :class:`_CacheForward` step run through an
    :class:`InferenceSession` (shape-signature accounting applies to every
    prefill and every decode step). Runs on the model's device.

    Parameters
    ----------
    model : LlamaModel (or any module with ``_blocks[i].attention`` KV
        geometry and a ``cache=``/``start_pos=``/``last_idx=`` forward).
    max_seq : ring length — prompt + generated tokens must fit.
    batch_buckets / prompt_buckets : the shape lattice.
    decode_path : which rung this generator runs (see
        :func:`resolve_decode_path`): "pallas" routes every decode step's
        attention through the CUDA decode-attention kernel; "int8" adds
        int8 KV rings and, when ``MXNET_SERVE_DECODE_INT8_WEIGHTS`` asks
        for it, int8 projection weights. "baseline" is not ported yet and
        raises ``NotImplementedError``.
    paged : back the KV state with a :class:`~.kv_blocks.PagedKVPool` per
        batch bucket instead of contiguous rings (``None`` reads
        ``MXNET_SERVE_KV_PAGED``). Without the prefix cache the pool is
        fully assigned with identity page tables.
    page_size / kv_pages : pool geometry overrides (see
        :class:`~.kv_blocks.PagedKVPool`).
    prefix_cache : a radix trie per batch bucket over its pool (``None``
        reads ``MXNET_SERVE_PREFIX_CACHE``; implies ``paged``): each
        prompt's longest cached prefix arrives as shared pages and skips
        prefill; clean retirements adopt their prompt pages into the trie.
    multistep / decode_steps : run the token loop as super-steps of up to
        ``decode_steps`` (N) iterations per host visit (``None`` reads
        ``MXNET_SERVE_MULTISTEP`` / ``MXNET_SERVE_DECODE_STEPS``; see
        :class:`_MultiStepForward`). On a GPU every super-step replays a
        CUDA graph, captured per batch bucket and key (N or 1 steps,
        greedy or sampled, attention routing) by :meth:`warmup` or at
        first use; a capture or replay error raises. On the CPU the same
        body runs as a plain loop.

    The rings or pools of each batch bucket are allocated once and written
    in place by every request, so one Generator serves one ``generate``
    call at a time. Stale contents between requests are never read:
    prefill overwrites every position its attention reads, and the
    position mask admits no position the current request has not written.
    """

    def __init__(self, model, max_seq=128, batch_buckets=(1, 2, 4),
                 prompt_buckets=None, pad_id=0, name="llama_decode",
                 decode_path=None, paged=None, page_size=None,
                 kv_pages=None, prefix_cache=None, multistep=None,
                 decode_steps=None):
        self.model = model
        self.device = next(model.parameters()).device
        self.max_seq = int(max_seq)
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        if prompt_buckets is None:
            prompt_buckets, p = [], 16
            while p < self.max_seq:
                prompt_buckets.append(p)
                p *= 2
            prompt_buckets.append(self.max_seq)
        self.prompt_buckets = tuple(sorted(set(int(p)
                                               for p in prompt_buckets)))
        if self.prompt_buckets[-1] > self.max_seq:
            raise MXNetError("prompt bucket exceeds max_seq")
        self.pad_id = int(pad_id)
        self.decode_path = resolve_decode_path(decode_path)
        if self.decode_path == "baseline":
            raise NotImplementedError(
                "the strict 'baseline' decode rung (stable_dense and the "
                "mul+reduce cached_attention) is ported in a later slice of "
                "the serving port; use decode_path='pallas' or 'int8'")
        self._quant = "int8" if self.decode_path == "int8" else None
        self._qweights = {}
        if self._quant and _int8_weights_enabled(self.device):
            self._qweights = _quantize_serving_weights(model)
        if prefix_cache is None:
            prefix_cache = bool(config.get("MXNET_SERVE_PREFIX_CACHE"))
        self._prefix_on = bool(prefix_cache)
        if self._prefix_on and paged is False:
            raise MXNetError(
                "prefix_cache requires the paged KV pool (prefix pages "
                "are shared pool pages); don't pass paged=False with "
                "prefix_cache on")
        self._paged = (bool(config.get("MXNET_SERVE_KV_PAGED"))
                       if paged is None else bool(paged)) or self._prefix_on
        self._page_size = page_size
        self._kv_pages = kv_pages
        self._prefix = {}  # batch bucket -> PrefixCache over its pool
        # speculative decoding sets this to k+1: its draft and verify
        # passes write that many positions past the accepted prefix, so
        # per-request page budgets must cover them
        self._budget_headroom = 0
        self._step = _CacheForward(model, self.max_seq,
                                   path=self.decode_path, quant=self._quant,
                                   quant_weights=self._qweights,
                                   paged=self._paged)
        self.session = InferenceSession(
            self._step, batch_buckets=self.batch_buckets,
            seq_buckets=self.prompt_buckets, pad_value=self.pad_id,
            name=name, device=self.device)
        self._zero_caches = {}  # batch bucket -> its rings or pool
        if multistep is None:
            multistep = bool(config.get("MXNET_SERVE_MULTISTEP"))
        self._multistep = bool(multistep)
        if decode_steps is None:
            decode_steps = int(config.get("MXNET_SERVE_DECODE_STEPS"))
        self.decode_steps = max(1, int(decode_steps))
        self._msession = None
        self._itl_est = None  # EMA seconds per decode iteration
        if self._multistep:
            self._mstep = _MultiStepForward(
                model, self.max_seq, path=self.decode_path,
                quant=self._quant, quant_weights=self._qweights,
                paged=self._paged)
            self._msession = GraphSession(
                f"{name}_multi", self.device,
                counters=_graph_counters(self._qweights), owner=self.session)
            self._inputs = {}  # batch bucket -> _SuperInputs

    def _fresh_cache(self, batch_bucket):
        """The rings of one batch bucket, allocated zeroed on first use and
        reused by every later request (see the class docstring).

        Paged mode returns the bucket's persistent
        :class:`~.kv_blocks.PagedKVPool` instead: fully assigned with
        identity page tables (slot ``s`` owns pages ``[1 + s*N,
        1 + (s+1)*N)``), or, with the prefix cache, assigned per
        ``generate`` and paired with the bucket's trie."""
        cache = self._zero_caches.get(batch_bucket)
        if cache is not None:
            return cache
        if self._paged:
            from .kv_blocks import PagedKVPool
            from .prefix_cache import PrefixCache

            cache = PagedKVPool(self.model, batch_bucket, self.max_seq,
                                page_size=self._page_size,
                                num_pages=self._kv_pages, quant=self._quant,
                                device=self.device)
            if self._prefix_on:
                self._prefix[batch_bucket] = PrefixCache(
                    cache, name=f"{self.session.name}_prefix")
            else:
                for s in range(batch_bucket):
                    cache.assign(s, self.max_seq)
        else:
            cache = KVCache.alloc(self.model, batch_bucket, self.max_seq,
                                  quant=self._quant, device=self.device)
        return self._zero_caches.setdefault(batch_bucket, cache)

    def kv_cache_bytes(self):
        """Bytes held by the rings or pools of every batch bucket allocated
        so far."""
        return sum(c.nbytes() for c in self._zero_caches.values())

    # -- phase helpers (also the parity-test surface) -----------------------
    def _run(self, tokens, start_pos, last_idx, cache):
        def dev(x):
            return torch.as_tensor(_onp.asarray(x, _onp.int32),
                                   device=self.device)

        args = (dev(tokens), dev(start_pos), dev(last_idx))
        if self._paged:
            out = self.session.run(*args, cache.table_nd(), *cache.flat())
            cache.update_from_flat(out[1:])
            return out[0], cache
        out = self.session.run(*args, *cache.flat())
        logits, flat = out[0], out[1:]
        return logits, KVCache.from_flat(flat, self.max_seq,
                                         quant=self._quant)

    def prefill(self, prompts, prompt_lens, cache):
        """Run the prompt block through the cache path. ``prompts`` is a
        host (B, T_bucket) int array (already padded), ``prompt_lens`` the
        (B,) real lengths. Returns ((B, vocab) last-real-position logits,
        updated cache)."""
        b = len(prompt_lens)
        zeros = _onp.zeros(b, _onp.int32)
        last = _onp.asarray(prompt_lens, _onp.int32) - 1
        return self._run(prompts, zeros, last, cache)

    def decode_step(self, tokens, positions, cache):
        """One T=1 decode step: ``tokens`` (B,) the just-sampled ids,
        ``positions`` (B,) their absolute positions. Returns the next
        (B, vocab) logits and the updated cache. The ``serve:decode``
        fault site fires once per step (distinct from ``serve:execute``,
        which also covers prefill)."""
        _faults.fault_point("serve:decode", {"session": self.session.name})
        toks = _onp.asarray(tokens, _onp.int32).reshape(-1, 1)
        zeros = _onp.zeros(len(toks), _onp.int32)
        return self._run(toks, _onp.asarray(positions, _onp.int32),
                         zeros, cache)

    def decode_super(self, tokens, positions, steps_limit, remaining,
                     seeds, temps, top_ks, stops, key_bits, cache,
                     events=None):
        """One multi-step super-step of ``steps_limit`` (N or 1) decode
        iterations (see :class:`_MultiStepForward`). Inputs are host
        arrays, one entry per lane of the batch bucket. Copies them into
        the bucket's static buffers in one host-to-device copy, replays
        the graph of (bucket, steps, sampled, routing) — capturing it
        first if this is its first use — and reads the block back in one
        copy. Returns ``(block, valid, done, cache)`` as host numpy: the
        (B, steps) token block (-1 where a lane was done), per-lane valid
        counts and done flags.

        ``events``: optional list; on a GPU one (start, end) pair of CUDA
        events recorded around the replay is appended (its device
        time)."""
        if self._msession is None:
            raise MXNetError(
                "decode_super needs multistep=True (or "
                "MXNET_SERVE_MULTISTEP=1) at construction")
        _faults.fault_point("serve:decode",
                            {"session": self._msession.name})
        steps = int(steps_limit)
        if steps not in (1, self.decode_steps):
            raise MXNetError(f"decode_super: steps_limit {steps} is neither "
                             f"1 nor decode_steps ({self.decode_steps})")
        b = len(positions)
        inp = self._inputs.get(b)
        if inp is None:
            pages = cache.pages_per_slot if self._paged else 0
            inp = self._inputs[b] = _SuperInputs(b, pages, self.decode_steps,
                                                 self.device)
        arrays = dict(tokens=tokens, start_pos=positions,
                      remaining=remaining, seeds=seeds, temps=temps,
                      top_ks=top_ks, stops=stops,
                      key_bits=_onp.asarray(key_bits, _onp.uint32))
        if self._paged:
            arrays["page_table"] = cache.table()
        block, valid, done = _replay_super(self._msession, self._mstep, inp,
                                           steps, cache.flat(), arrays,
                                           events=events)
        return block, valid, done, cache

    # -- the serving API ----------------------------------------------------
    def _pad_prompts(self, prompts):
        lens = _onp.asarray([len(p) for p in prompts], _onp.int32)
        if int(lens.min()) < 1:
            raise MXNetError("empty prompt (need >= 1 token)")
        t_bucket = pick_bucket(int(lens.max()), self.prompt_buckets)
        b_bucket = pick_bucket(len(prompts), self.batch_buckets)
        toks = _onp.full((b_bucket, t_bucket), self.pad_id, _onp.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        full_lens = _onp.ones(b_bucket, _onp.int32)
        full_lens[:len(prompts)] = lens
        # dead batch lanes replay prompt 0's first token at length 1
        toks[len(prompts):, 0] = toks[0, 0]
        return toks, full_lens, b_bucket

    # -- prefix-cache plumbing ------------------------------------------------
    def _prefix_begin(self, prompts, toks, lens, b_bucket, max_new):
        """Reserve the batch's slots in the bucket's pool. With the
        prefix trie on, each real row's longest cached prefix arrives as
        shared (refcounted) pages at the front of its table row and its
        ``matched`` count says how many prompt tokens skip prefill; pool
        pressure LRU-evicts cached prefixes (never the pages just
        matched) before surfacing :class:`PoolExhausted`. Returns
        ``(cache, matched)``; otherwise the persistent rings or
        fully-assigned pool and all-zero ``matched``."""
        cache = self._fresh_cache(b_bucket)
        matched = _onp.zeros(b_bucket, _onp.int32)
        if not self._prefix_on:
            return cache, matched
        trie = self._prefix[b_bucket]
        try:
            for s in range(b_bucket):
                if s < len(prompts):
                    row = [int(t) for t in prompts[s]]
                    m, pages = trie.match(row)
                else:  # dead padding lane: 1-token prompt, never cached
                    row, m, pages = [int(toks[s, 0])], 0, ()
                budget = min(len(row) + int(max_new)
                             + self._budget_headroom, self.max_seq)
                try:
                    cache.assign_with_prefix(s, budget, pages)
                except PoolExhausted:
                    shortfall = (cache.pages_for(budget) - len(pages)
                                 - cache.pages_free)
                    if trie.reclaim(max(shortfall, 1),
                                    exclude=pages) == 0:
                        raise
                    cache.assign_with_prefix(s, budget, pages)
                matched[s] = m
        except BaseException:
            for s in range(b_bucket):
                cache.release(s)
            raise
        return cache, matched

    def _prefix_prefill(self, toks, lens, matched, cache):
        """Prefill only each row's un-cached tail: row ``s``'s tokens
        ``[matched[s]:lens[s]]`` at ``start_pos=matched[s]``. The tail
        bucket comes from the same prompt lattice warmup ran — no new
        signature. All-miss batches take the unchanged full path."""
        if not matched.any():
            return self.prefill(toks, lens, cache)
        tail_lens = (_onp.asarray(lens, _onp.int32)
                     - _onp.asarray(matched, _onp.int32))
        t_bucket = pick_bucket(int(tail_lens.max()), self.prompt_buckets)
        tails = _onp.full((len(lens), t_bucket), self.pad_id, _onp.int32)
        for s in range(len(lens)):
            tails[s, :tail_lens[s]] = toks[s, matched[s]:lens[s]]
        return self._run(tails, matched, tail_lens - 1, cache)

    def _prefix_release(self, prompts, b_bucket, cache, ok):
        """Retire the batch's slots. On a clean run the trie first adopts
        each real prompt's full pages (increfs while the slot still pins
        them); then every slot's references drop — pages the trie kept
        survive, the rest recycle."""
        if not self._prefix_on:
            return
        trie = self._prefix[b_bucket]
        if ok:
            table = cache.table()
            for s, p in enumerate(prompts):
                trie.insert([int(t) for t in p], table[s])
        for s in range(b_bucket):
            cache.release(s)

    def generate(self, prompts, max_new_tokens=32, temperature=0.0,
                 top_k=None, stop_ids=(), deadlines=None):
        """Generate continuations for a batch of prompts (lists of ids).

        ``deadlines`` (optional) carries absolute ``time.monotonic()``
        deadlines — one scalar for the whole batch or one per prompt. A
        row whose deadline passes is **retired between decode steps** (or
        super-steps): it stops consuming decode work, keeps the tokens
        generated so far, and lands in ``info["deadline_expired"]``. When
        every live row has expired the decode loop exits early.

        Returns ``(outputs, info)``: per-prompt generated id lists (stop
        token excluded) and a stats dict (tokens/s, per-phase wall time,
        decode iterations and host visits, expired row indices). Every
        phase ends in a host read of the sampled ids, so the wall times
        cover the device work.
        """
        t_start = time.perf_counter()
        toks, lens, b_bucket = self._pad_prompts(prompts)
        n_real = len(prompts)
        max_new = int(max_new_tokens)
        if int(lens.max()) + max_new > self.max_seq:
            raise MXNetError(
                f"prompt ({int(lens.max())}) + max_new_tokens ({max_new}) "
                f"exceeds max_seq ({self.max_seq})")
        if deadlines is not None:
            try:
                deadlines = [float(d) for d in deadlines]
            except TypeError:
                deadlines = [float(deadlines)] * n_real
            if len(deadlines) != n_real:
                raise MXNetError(
                    f"generate() got {len(deadlines)} deadlines for "
                    f"{n_real} prompts")
        cache, matched = self._prefix_begin(prompts, toks, lens, b_bucket,
                                            max_new)
        run_ok = False
        try:
            logits, cache = self._prefix_prefill(toks, lens, matched, cache)
            next_ids = sample_tokens(logits, temperature=temperature,
                                     top_k=top_k)
            t_prefill = time.perf_counter()

            out = [[] for _ in range(n_real)]
            stopped = [False] * n_real
            expired = [False] * n_real
            positions = lens.copy()  # next write position per row
            stop = set(int(s) for s in stop_ids)
            if self._multistep:
                n_decoded, n_visits = self._decode_loop_multi(
                    next_ids, positions, out, stopped, expired, stop,
                    max_new, temperature, top_k, deadlines, cache,
                    n_real, b_bucket)
            else:
                n_decoded = self._decode_loop(
                    next_ids, positions, out, stopped, expired, stop,
                    max_new, temperature, top_k, deadlines, cache, n_real)
                n_visits = n_decoded
            run_ok = True
        finally:
            self._prefix_release(prompts, b_bucket, cache, run_ok)
        t_done = time.perf_counter()
        decode_s = t_done - t_prefill
        n_tokens = sum(len(o) for o in out)
        info = {
            "prefill_ms": (t_prefill - t_start) * 1e3,
            "decode_ms": decode_s * 1e3,
            "decode_steps": n_decoded,
            "decode_visits": n_visits,
            "tokens_s": n_tokens / decode_s if decode_s > 0 else 0.0,
            "total_ms": (t_done - t_start) * 1e3,
            "deadline_expired": [i for i in range(n_real) if expired[i]],
        }
        return out, info

    @staticmethod
    def _retire_expired(deadlines, stopped, expired):
        """Retire the rows whose deadline has passed (at a step or
        super-step boundary: further passes for output nobody will read
        are the overload failure mode)."""
        if deadlines is None:
            return
        now = time.monotonic()
        for i in range(len(stopped)):
            if not stopped[i] and now >= deadlines[i]:
                stopped[i] = True
                expired[i] = True

    def _decode_loop(self, next_ids, positions, out, stopped, expired,
                     stop, max_new, temperature, top_k, deadlines, cache,
                     n_real):
        """The single-step decode loop: one T=1 step and one host read of
        the sampled ids per token. Returns the decode steps run."""
        n_decoded = 0
        for step in range(max_new):
            for i in range(n_real):
                if stopped[i]:
                    continue
                tid = int(next_ids[i])
                if tid in stop:
                    stopped[i] = True
                else:
                    out[i].append(tid)
            self._retire_expired(deadlines, stopped, expired)
            if all(stopped) or step == max_new - 1:
                # the last sampled token needs no successor logits
                break
            logits, cache = self.decode_step(next_ids, positions, cache)
            next_ids = sample_tokens(logits, temperature=temperature,
                                     top_k=top_k)
            positions = positions + 1
            n_decoded += 1
        return n_decoded

    def _steps_limit(self, deadlines, stopped, n_real):
        """The next super-step's iteration count: N, degraded to 1 when
        some live row's deadline could not survive a full N-iteration
        super-step (estimated off the per-iteration EMA), so 504
        retirement latency stays bounded by about one decode iteration.
        Both counts have their graph captured at warmup: no new
        signature."""
        n = self.decode_steps
        if deadlines is None or self._itl_est is None:
            return n
        now = time.monotonic()
        slack = min((deadlines[i] - now for i in range(n_real)
                     if not stopped[i]), default=None)
        if slack is not None and slack < self._itl_est * n:
            return 1
        return n

    def _decode_loop_multi(self, next_ids, positions, out, stopped,
                           expired, stop, max_new, temperature, top_k,
                           deadlines, cache, n_real, b_bucket):
        """The multi-step decode loop: the step-0 token is emitted on the
        host (exactly like single-step), then every further token comes
        out of super-steps — one host visit per block of up to
        ``decode_steps`` tokens, settled in one pass over the returned
        block. Token streams do not depend on where a super-step ends
        (counter-based on-device keys), so N=8 and N=1 output is
        identical, and greedy output matches the single-step loop token
        for token. Returns (decode iterations, host visits)."""
        for i in range(n_real):
            tid = int(next_ids[i])
            if tid in stop:
                stopped[i] = True
            else:
                out[i].append(tid)
                if len(out[i]) >= max_new:
                    stopped[i] = True
        pending = _onp.zeros(b_bucket, _onp.int32)
        pending[:len(next_ids)] = _onp.asarray(next_ids, _onp.int32)
        temp = float(temperature) if temperature is not None else 0.0
        # greedy runs draw no host key (the single-step greedy path draws
        # nothing either)
        key_bits = (_fresh_key_bits() if temp > 0.0
                    else _onp.zeros(2, _onp.uint32))
        seeds = _onp.arange(b_bucket, dtype=_onp.int32)
        temps = _onp.full(b_bucket, max(temp, 0.0), _onp.float32)
        tks = _onp.full(b_bucket, int(top_k) if top_k else 0, _onp.int32)
        stops_m = _stop_matrix(b_bucket, [stop] * b_bucket)
        n_decoded = n_visits = 0
        while True:
            self._retire_expired(deadlines, stopped, expired)
            if all(stopped):
                break
            remaining = _onp.zeros(b_bucket, _onp.int32)
            for i in range(n_real):
                if not stopped[i]:
                    remaining[i] = max_new - len(out[i])
            limit = self._steps_limit(deadlines, stopped, n_real)
            t1 = time.perf_counter()
            block, valid, _done, cache = self.decode_super(
                pending, positions, limit, remaining, seeds, temps, tks,
                stops_m, key_bits, cache)
            t3 = time.perf_counter()
            steps_run = int(valid.max()) if valid.size else 0
            for i in range(n_real):
                if stopped[i]:
                    continue
                k = int(valid[i])
                for j in range(k):
                    tid = int(block[i, j])
                    if tid in stop:
                        stopped[i] = True
                        break
                    out[i].append(tid)
                    pending[i] = tid
                    if len(out[i]) >= max_new:
                        stopped[i] = True
                        break
                positions[i] += k
            if steps_run > 0:
                est = (t3 - t1) / steps_run
                self._itl_est = (est if self._itl_est is None
                                 else 0.5 * self._itl_est + 0.5 * est)
            n_decoded += steps_run
            n_visits += 1
        return n_decoded, n_visits

    # -- warmup / invariants -------------------------------------------------
    def warmup(self):
        """Run every (batch bucket x prompt bucket) prefill and every batch
        bucket's decode step once — plus, in multistep mode, capture every
        batch bucket's super-step graphs (N and 1 steps, greedy and
        sampled) — then freeze the signature sets so
        ``assert_no_recompiles`` guards steady state. Returns the
        signature count, the wall time, and (multistep) the graphs
        captured and the seconds their captures took."""
        t0 = time.perf_counter()
        t_cap = 0.0
        for bb in self.batch_buckets:
            for pb in self.prompt_buckets:
                cache = self._fresh_cache(bb)
                toks = _onp.zeros((bb, pb), _onp.int32)
                lens = _onp.ones(bb, _onp.int32)
                logits, cache = self.prefill(toks, lens, cache)
                if pb == self.prompt_buckets[0]:
                    ids = _onp.zeros(bb, _onp.int32)
                    self.decode_step(ids, lens, cache)
            if self._multistep:
                t1 = time.perf_counter()
                zeros = _onp.zeros(bb, _onp.int32)
                for steps in sorted({self.decode_steps, 1}):
                    for temp in (0.0, 1.0):
                        # remaining = 0: every lane is done from the
                        # start and only rewrites its current position
                        self.decode_super(
                            zeros, lens, steps, zeros, zeros,
                            _onp.full(bb, temp, _onp.float32), zeros,
                            _onp.full((bb, _STOP_WIDTH), -1, _onp.int32),
                            _onp.zeros(2, _onp.uint32), cache)
                t_cap += time.perf_counter() - t1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.session.freeze_signatures()
        sigs = self.session.signature_count()
        out = {}
        if self._msession is not None:
            self._msession.freeze_signatures()
            sigs += self._msession.signature_count()
            out = {"captures": self._msession.captures,
                   "capture_s": t_cap}
        return dict({"signatures": sigs,
                     "wall_s": time.perf_counter() - t0}, **out)

    def assert_no_recompiles(self):
        self.session.assert_no_recompiles()
        if self._msession is not None:
            self._msession.assert_no_recompiles()

    def stats(self):
        """Signature counts, and the pools' and tries' counters."""
        out = {"signatures": self.session.signature_count()}
        if self._msession is not None:
            out["multistep"] = {
                "signatures": self._msession.signature_count(),
                "captures": self._msession.captures}
            out["decode_steps"] = self.decode_steps
        if self._paged:
            out["pool"] = {bb: c.stats()
                           for bb, c in self._zero_caches.items()}
        if self._prefix_on:
            out["prefix"] = {bb: t.stats() for bb, t in self._prefix.items()}
        return out


class SpeculativeGenerator:
    """Speculative decoding (Leviathan et al.): a cheap draft model
    proposes ``k`` tokens per round, the target model scores the whole
    block in ONE (k+1)-wide verify pass, and the longest proposal prefix
    that matches the target's greedy choices is accepted plus one
    correction/bonus token — so each target pass emits between 1 and k+1
    tokens instead of exactly 1.

    Greedy-only by construction: with argmax acceptance the emitted
    sequence is **token-identical** to non-speculative greedy decoding
    for *any* draft model (a bad draft only costs speed, never output).
    The accepted prefix always equals the target's own greedy chain, and
    the correction token is the target's argmax conditioned on exactly
    that chain.

    No cache rollback is needed on rejection: the attention masks
    positions past each query's own, so the K/V of rejected proposals is
    dead weight that the next round's writes overwrite before any read
    reaches it — in rings and in paged pools alike (the verify pass
    writes its k+1 rows at the row's ``start_pos`` through the page
    table).

    The target and draft are plain :class:`Generator` s; the target stays
    single-step (prefill and verify are its only passes). With
    ``multistep`` the draft is a multi-step ``Generator`` with
    ``decode_steps = k + 1``: a round's k proposal iterations plus the
    (k+1)-th that writes d_k's K/V are ONE super-step replay, with the
    decode-attention kernel in every layer of every iteration. The verify
    pass is a third session: on a GPU one CUDA graph per batch bucket
    (:class:`~.engine.GraphSession`, captured in :meth:`warmup`) over
    static input buffers, writing the target's rings or pools in place;
    on the CPU the same body runs eagerly. Its attention is the plain
    version (T = k+1 > 1, as the JAX package routes T > 1 to
    ``_xla_decode``). So a multi-step round costs two host visits: one
    draft replay and one verify replay. :meth:`assert_no_recompiles`
    spans all three sessions.
    """

    def __init__(self, model, draft_model, k=None, max_seq=128,
                 batch_buckets=(1, 2, 4), prompt_buckets=None, pad_id=0,
                 name="llama_spec", decode_path=None, paged=None,
                 page_size=None, kv_pages=None, prefix_cache=None,
                 multistep=None):
        self.k = int(k) if k is not None else int(
            config.get("MXNET_SERVE_SPEC_TOKENS"))
        if self.k < 1:
            raise MXNetError("speculative decoding needs k >= 1")
        if multistep is None:
            multistep = bool(config.get("MXNET_SERVE_MULTISTEP"))
        self._multistep = bool(multistep)
        self.target = Generator(
            model, max_seq=max_seq, batch_buckets=batch_buckets,
            prompt_buckets=prompt_buckets, pad_id=pad_id, name=name,
            decode_path=decode_path, paged=paged, page_size=page_size,
            kv_pages=kv_pages, prefix_cache=prefix_cache, multistep=False)
        self.draft = Generator(
            draft_model, max_seq=max_seq, batch_buckets=batch_buckets,
            prompt_buckets=prompt_buckets, pad_id=pad_id,
            name=f"{name}_draft", decode_path=decode_path, paged=paged,
            page_size=page_size, kv_pages=kv_pages,
            prefix_cache=prefix_cache, multistep=self._multistep,
            decode_steps=self.k + 1)
        if self.draft.device != self.target.device:
            raise MXNetError(
                f"draft model on {self.draft.device}, target on "
                f"{self.target.device}: both must live on one device")
        # draft rounds write k+1 positions past the accepted prefix and
        # the verify block writes k+1 target positions — per-request
        # page budgets in prefix mode must cover that overhang
        self.target._budget_headroom = self.k + 1
        self.draft._budget_headroom = self.k + 1
        self.decode_path = self.target.decode_path
        self.max_seq = self.target.max_seq
        self.batch_buckets = self.target.batch_buckets
        self.pad_id = self.target.pad_id
        self.device = self.target.device
        self._verify_step = _CacheForward(
            model, self.max_seq, path=self.decode_path,
            quant=self.target._quant, quant_weights=self.target._qweights,
            all_logits=True, paged=self.target._paged)
        self._verify = GraphSession(
            f"{name}_verify", self.device,
            counters=_graph_counters(self.target._qweights),
            owner=self.target.session)
        self._vinputs = {}  # batch bucket -> _VerifyInputs
        self.metrics = self.target.session.metrics

    def _verify_run(self, tokens_blk, start_pos, cache, events=None):
        """One target pass over the (B, k+1) block [pending, d_1..d_k] at
        per-row ``start_pos``, writing the target's rings (or, paged, its
        pool pages through the table) in place. Fills the bucket's static
        buffers in one copy and replays its verify graph — capturing it
        first on its first use — then reads the (B, k+1) greedy ids back
        in one copy. Returns ``(logits, greedy, cache)``: the (B, k+1,
        vocab) logits on the device (valid until the next verify pass),
        the ids as host numpy, and the cache.

        ``events``: optional list; on a GPU one (start, end) pair of CUDA
        events recorded around the replay is appended."""
        blk = _onp.asarray(tokens_blk, _onp.int32)
        b = blk.shape[0]
        inp = self._vinputs.get(b)
        if inp is None:
            pages = cache.pages_per_slot if self.target._paged else 0
            inp = self._vinputs[b] = _VerifyInputs(b, self.k + 1, pages,
                                                   self.device)
        arrays = dict(tokens=blk, start_pos=_onp.asarray(start_pos,
                                                         _onp.int32),
                      last_idx=_onp.zeros(b, _onp.int32))
        if self.target._paged:
            arrays["page_table"] = cache.table()
        inp.fill(**arrays)
        flat = cache.flat()

        def body():
            out = self._verify_step(*inp.views(), *flat)
            return out[0], torch.argmax(out[0], dim=-1).to(torch.int32)

        timed = events is not None and self._verify.graphs
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        logits, ids = self._verify.run((b, self.k + 1, _graph_route()), body)
        if timed:
            e1.record()
            events.append((e0, e1))
        return logits, inp.read(ids), cache

    def generate(self, prompts, max_new_tokens=32, temperature=0.0,
                 top_k=None, stop_ids=(), deadlines=None, events=None):
        """Same contract as :meth:`Generator.generate` (greedy only):
        per-prompt generated id lists plus a stats dict — with
        ``rounds``, ``draft_steps``, ``verify_steps``, the measured
        ``acceptance_rate`` and ``decode_visits`` (host visits after
        prefill: 2 a round with ``multistep``, k+2 without) added.

        ``events``: optional ``{"draft": [], "verify": []}``; on a GPU one
        pair of CUDA events around each multi-step draft replay and each
        verify replay is appended (their device times)."""
        if temperature is not None and temperature > 0.0:
            raise MXNetError(
                "SpeculativeGenerator is greedy-only: sampled acceptance "
                "needs the rejection-sampling correction this build does "
                "not implement (temperature must be 0)")
        t_start = time.perf_counter()
        toks, lens, b_bucket = self.target._pad_prompts(prompts)
        n_real = len(prompts)
        max_new = int(max_new_tokens)
        # +k+1 headroom: the last round's verify block writes k+1
        # positions past the accepted prefix
        if int(lens.max()) + max_new + self.k + 1 > self.max_seq:
            raise MXNetError(
                f"prompt ({int(lens.max())}) + max_new_tokens ({max_new}) "
                f"+ speculative headroom ({self.k + 1}) exceeds max_seq "
                f"({self.max_seq})")
        if deadlines is not None:
            try:
                deadlines = [float(d) for d in deadlines]
            except TypeError:
                deadlines = [float(deadlines)] * n_real
            if len(deadlines) != n_real:
                raise MXNetError(
                    f"generate() got {len(deadlines)} deadlines for "
                    f"{n_real} prompts")
        draft_ev = events.get("draft") if events is not None else None
        verify_ev = events.get("verify") if events is not None else None
        tcache, tmatched = self.target._prefix_begin(
            prompts, toks, lens, b_bucket, max_new)
        try:
            dcache, dmatched = self.draft._prefix_begin(
                prompts, toks, lens, b_bucket, max_new)
        except BaseException:
            self.target._prefix_release(prompts, b_bucket, tcache, False)
            raise
        run_ok = False
        try:
            with _trace.span("serve::prefill", {"batch": n_real}):
                logits, tcache = self.target._prefix_prefill(
                    toks, lens, tmatched, tcache)
                _, dcache = self.draft._prefix_prefill(
                    toks, lens, dmatched, dcache)
            pending = sample_tokens(logits)  # (b_bucket,) greedy
            t_prefill = time.perf_counter()

            out = [[] for _ in range(n_real)]
            stopped = [False] * b_bucket
            for i in range(n_real, b_bucket):
                stopped[i] = True  # dead padding lanes ride along frozen
            expired = [False] * n_real
            stop = set(int(s) for s in stop_ids)
            # the prefill-sampled token is the first emission (exactly
            # like Generator.generate's step-0 sample)
            for i in range(n_real):
                tid = int(pending[i])
                if tid in stop:
                    stopped[i] = True
                else:
                    out[i].append(tid)
                    if len(out[i]) >= max_new:
                        stopped[i] = True
            positions = lens.copy()  # write position of row's `pending`
            rounds = draft_steps = verify_steps = visits = 0
            proposed = accepted = 0
            proposals = _onp.zeros((b_bucket, self.k), _onp.int32)
            while not all(stopped):
                rounds += 1
                # draft proposes d_1..d_k; the extra (k+1)-th iteration
                # writes d_k's K/V into the draft's cache so a fully
                # accepted round leaves no hole at position + k
                if self._multistep:
                    # one super-step replay runs all k+1 draft
                    # iterations: iteration j feeds d_j at pos+j, writes
                    # its K/V and greedily picks d_{j+1}. No stops and no
                    # budget (remaining = k+2): every lane runs the full
                    # k+1 iterations, and proposals of frozen lanes are
                    # ignored at settle
                    with _trace.span("serve::draft_step",
                                     {"steps": self.k + 1}):
                        blk_d, _, _, dcache = self.draft.decode_super(
                            pending, positions, self.k + 1,
                            _onp.full(b_bucket, self.k + 2, _onp.int32),
                            _onp.arange(b_bucket, dtype=_onp.int32),
                            _onp.zeros(b_bucket, _onp.float32),
                            _onp.zeros(b_bucket, _onp.int32),
                            _onp.full((b_bucket, _STOP_WIDTH), -1,
                                      _onp.int32),
                            _onp.zeros(2, _onp.uint32), dcache,
                            events=draft_ev)
                    draft_steps += self.k + 1
                    visits += 1
                    proposals[:, :] = blk_d[:, :self.k]
                else:
                    cur = _onp.asarray(pending, _onp.int32).copy()
                    dpos = positions.copy()
                    for j in range(self.k + 1):
                        with _trace.span("serve::draft_step", {"j": j}):
                            dlog, dcache = self.draft.decode_step(
                                cur, dpos, dcache)
                            if j < self.k:
                                cur = sample_tokens(dlog)
                                proposals[:, j] = cur
                        dpos = dpos + 1
                        draft_steps += 1
                        visits += 1
                blk = _onp.concatenate(
                    [_onp.asarray(pending, _onp.int32).reshape(-1, 1),
                     proposals], axis=1)
                with _trace.span("serve::verify_step", {"k": self.k}):
                    _, greedy, tcache = self._verify_run(
                        blk, positions, tcache, events=verify_ev)
                verify_steps += 1
                visits += 1
                for i in range(b_bucket):
                    if stopped[i]:
                        continue
                    a = 0
                    while a < self.k and proposals[i, a] == greedy[i, a]:
                        a += 1
                    proposed += self.k
                    accepted += a
                    emit = [int(t) for t in proposals[i, :a]]
                    emit.append(int(greedy[i, a]))
                    for tid in emit:
                        if tid in stop:
                            stopped[i] = True
                            break
                        out[i].append(tid)
                        if len(out[i]) >= max_new:
                            stopped[i] = True
                            break
                    pending[i] = greedy[i, a]
                    positions[i] += a + 1
                if deadlines is not None:
                    now = time.monotonic()
                    for i in range(n_real):
                        if not stopped[i] and now >= deadlines[i]:
                            stopped[i] = True
                            expired[i] = True
                            self.metrics.observe_deadline("decode")
            run_ok = True
        finally:
            self.target._prefix_release(prompts, b_bucket, tcache, run_ok)
            self.draft._prefix_release(prompts, b_bucket, dcache, run_ok)
        t_done = time.perf_counter()
        decode_s = t_done - t_prefill
        n_tokens = sum(len(o) for o in out)
        self.metrics.observe_tokens(n_tokens, decode_s)
        info = {
            "prefill_ms": (t_prefill - t_start) * 1e3,
            "decode_ms": decode_s * 1e3,
            "rounds": rounds,
            "draft_steps": draft_steps,
            "verify_steps": verify_steps,
            "decode_visits": visits,
            "acceptance_rate": accepted / proposed if proposed else 0.0,
            "tokens_s": n_tokens / decode_s if decode_s > 0 else 0.0,
            "total_ms": (t_done - t_start) * 1e3,
            "deadline_expired": [i for i in range(n_real) if expired[i]],
        }
        return out, info

    # -- warmup / invariants -------------------------------------------------
    def warmup(self):
        """Warm all three sessions: the target and draft lattices (the
        draft's super-step graphs among them) plus one verify pass per
        batch bucket — on a GPU its graph capture. Returns the signature
        count, the wall time and the verify graphs captured."""
        t0 = time.perf_counter()
        self.target.warmup()
        self.draft.warmup()
        for bb in self.batch_buckets:
            cache = self.target._fresh_cache(bb)
            blk = _onp.zeros((bb, self.k + 1), _onp.int32)
            self._verify_run(blk, _onp.zeros(bb, _onp.int32), cache)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._verify.freeze_signatures()
        sigs = (self.target.session.signature_count()
                + self.draft.session.signature_count()
                + self._verify.signature_count())
        if self.draft._msession is not None:
            sigs += self.draft._msession.signature_count()
        return {"signatures": sigs, "wall_s": time.perf_counter() - t0,
                "verify_captures": self._verify.captures}

    def assert_no_recompiles(self):
        self.target.assert_no_recompiles()
        self.draft.assert_no_recompiles()
        self._verify.assert_no_recompiles()

    def stats(self):
        return {"target": self.target.stats(), "draft": self.draft.stats(),
                "verify": {"signatures": self._verify.signature_count(),
                           "captures": self._verify.captures,
                           "replays": self._verify.replays}}
