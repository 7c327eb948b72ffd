"""Llama-family decoder LM as ``torch.nn`` modules (counterpart of
``mxnet_tpu/models/llama.py``).

RMSNorm pre-normalization, rotary position embeddings on Q/K,
grouped-query attention, SwiGLU feed-forward, weight-tied or separate LM
head. Two paths, as in the JAX package:

* the cache-free forward (training): causal attention over the whole
  sequence through the flash-attention kernel module, K/V heads expanded
  to the query heads;
* the cache path (serving): attention over per-layer KV rings. On the
  ``pallas`` and ``int8`` rungs through the decode-attention kernel module
  and library (or int8) products; on the strict ``baseline`` rung every
  product, the attention and the norms through the shape-stable kernels of
  ``ops/hopper/stable_ops``, so a T = 1 decode step's logits are bit for
  bit those of a T = bucket prefill of the same prefix.

Mixed dtypes compute as ``jnp`` promotes them: products through
``ops.nn.dense`` (``F.linear`` refuses a bf16 input against an f32 weight
where ``jnp.dot`` promotes), RoPE by the f32 tables, which promote q and k.
So under ``parallel.ShardedTrainer(dtype="bfloat16")`` the first layer's
attention takes (q, k, v) in (f32, f32, bf16) and every later layer runs
in f32 on bf16-rounded weights, as the JAX package's does.

Module and parameter names follow the JAX package's, so
``named_parameters()`` yields exactly its ``collect_params()`` names
(``embed.weight``, ``layer{i}.attention.q_proj.weight``, ...), and
:func:`load_reference_params` carries its weights across unchanged: Gluon's
Dense keeps its weight as (out, in), which is ``nn.Linear``'s layout too.
"""
from __future__ import annotations

import functools

import numpy as _onp
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from .. import device as _device
from .. import random as _rng
from ..base import MXNetError
from ..ops import nn as _ops

@functools.lru_cache(maxsize=64)
def _rope_tables(t, dim, theta=10000.0):
    # computed in float64 with numpy and rounded to float32, exactly as the
    # JAX package does, so both packages rotate by the same table
    pos = _onp.arange(t)[:, None]
    freqs = 1.0 / (theta ** (_onp.arange(0, dim, 2)[None] / dim))
    ang = pos * freqs  # (T, dim/2)
    return _onp.cos(ang).astype("float32"), _onp.sin(ang).astype("float32")


@functools.lru_cache(maxsize=64)
def _rope_tables_on(t, dim, theta, device):
    # the serving loop asks for the same table num_layers times a step:
    # keep one copy on each device instead of copying it over every call
    cos, sin = _rope_tables(t, dim, theta)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def apply_rope(x, cos, sin):
    """Rotate pairs of channels: x is (B, H, T, D); cos/sin broadcast
    against (B, H, T, D/2)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    # re-interleave (..., D/2, 2) -> (..., D)
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def _stable(cache):
    """True on the strict ``baseline`` rung's cache path."""
    return getattr(cache, "path", None) == "baseline"


def _serving_dense(x, weight, cache):
    """Projection by ``weight`` (out, in): on the strict ``baseline`` rung
    ``ops.nn.stable_dense`` (each output one fixed-order sum, whatever the
    rows: the JAX package's cache path takes it for q/k/v/o, the FFN and
    the head); on the int8 serving rung the cache's pre-quantized side
    table (``ops.nn.quantized_dense``); otherwise ``ops.nn.dense``."""
    if _stable(cache):
        return _ops.stable_dense(x, weight)
    qw = getattr(cache, "quant_weights", None)
    entry = qw.get(id(weight)) if qw else None
    if entry is not None:
        return _ops.quantized_dense(x, entry[0], entry[1])
    return _ops.dense(x, weight)


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned ``gamma`` (counterpart of
    ``gluon.nn.RMSNorm``)."""

    def __init__(self, units, epsilon=1e-6, axis=-1):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        self.gamma = nn.Parameter(torch.ones(units))

    def forward(self, x, stable=False):
        """``stable=True`` (the strict cache path; last axis only) takes the
        shape-stable route, ``ops.nn.stable_rms_norm``."""
        if stable:
            return _ops.stable_rms_norm(x, self.gamma, eps=self._eps)
        return _ops.rms_norm(x, self.gamma, axis=self._axis, eps=self._eps)


class LlamaAttention(nn.Module):
    """Causal GQA attention with RoPE over a per-layer KV ring."""

    def __init__(self, units, num_heads, num_kv_heads=None, theta=10000.0):
        super().__init__()
        num_kv_heads = num_kv_heads or num_heads
        if units % num_heads or num_heads % num_kv_heads:
            raise MXNetError(
                f"units {units} / heads {num_heads} / kv {num_kv_heads} "
                "must divide")
        self._units = units
        self._heads = num_heads
        self._kv_heads = num_kv_heads
        self._head_dim = units // num_heads
        self._theta = theta
        kv_units = self._head_dim * num_kv_heads
        self.q_proj = nn.Linear(units, units, bias=False)
        self.k_proj = nn.Linear(units, kv_units, bias=False)
        self.v_proj = nn.Linear(units, kv_units, bias=False)
        self.o_proj = nn.Linear(units, units, bias=False)

    def _heads_split(self, x, n):
        b, t, _ = x.shape
        return x.reshape(b, t, n, self._head_dim).transpose(1, 2)

    def forward(self, x, cache=None, start_pos=None):
        """Attention of ``x`` (B, T, units): causal over ``x`` itself when
        ``cache`` is None (training), else at absolute positions
        ``start_pos[b] + t`` over ``cache`` (one layer's
        :class:`~mxnet_tpu_torch.serve.KVCache` slot)."""
        if cache is None:
            return self._forward_full(x)
        if start_pos is None:
            raise MXNetError("cache= requires start_pos (the (B,) "
                             "absolute position of x[:, 0])")
        return self._forward_cached(x, cache, start_pos,
                                    getattr(cache, "path", "pallas"))

    def _forward_full(self, x):
        """The cache-free forward: projections, RoPE from position 0, K/V
        heads repeated to the query heads (``mnp.repeat(k, rep, axis=1)``
        in the JAX package), then causal flash attention."""
        b, t, _ = x.shape
        q = self._heads_split(_ops.dense(x, self.q_proj.weight), self._heads)
        k = self._heads_split(_ops.dense(x, self.k_proj.weight),
                              self._kv_heads)
        v = self._heads_split(_ops.dense(x, self.v_proj.weight),
                              self._kv_heads)
        cos, sin = _rope_tables_on(t, self._head_dim, self._theta, x.device)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        rep = self._heads // self._kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        out = _ops.attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(b, t, self._units)
        return _ops.dense(out, self.o_proj.weight)

    def _forward_cached(self, x, cache, start_pos, path):
        """The serving rungs: the projections (``_serving_dense``: library,
        int8 or, on ``baseline``, shape-stable products), the new K/V rows
        written into the ring in place, and ``cached_attention`` over the
        *unexpanded* GQA rings: the decode-attention kernel on
        ``pallas``/``int8``, the shape-stable mul+reduce on ``baseline``
        (where the JAX package repeats the K/V heads at use; head h reads KV
        head h // G here, the same values)."""
        b, t, _ = x.shape

        def proj(layer, heads):
            return self._heads_split(_serving_dense(x, layer.weight, cache),
                                     heads)

        q = proj(self.q_proj, self._heads)
        k = proj(self.k_proj, self._kv_heads)
        v = proj(self.v_proj, self._kv_heads)
        cos_t, sin_t = _rope_tables_on(cache.max_seq, self._head_dim,
                                       self._theta, x.device)
        cos, sin = _ops.rope_positions(cos_t, sin_t, start_pos, t)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if getattr(cache, "quant", None) == "int8":
            k_all, k_s = _ops.kv_cache_write_q(cache.k, cache.k_scale, k,
                                               start_pos)
            v_all, v_s = _ops.kv_cache_write_q(cache.v, cache.v_scale, v,
                                               start_pos)
            cache.update(k_all, v_all, k_s, v_s)
            out = _ops.cached_attention(q, k_all, v_all, start_pos,
                                        path=path, k_scale=k_s,
                                        v_scale=v_s)
        else:
            k_all = _ops.kv_cache_write(cache.k, k, start_pos)
            v_all = _ops.kv_cache_write(cache.v, v, start_pos)
            cache.update(k_all, v_all)
            out = _ops.cached_attention(q, k_all, v_all, start_pos,
                                        path=path)
        out = out.transpose(1, 2).reshape(b, t, self._units)
        return _serving_dense(out, self.o_proj.weight, cache)


class LlamaFFN(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, units, hidden_size):
        super().__init__()
        self.gate_proj = nn.Linear(units, hidden_size, bias=False)
        self.up_proj = nn.Linear(units, hidden_size, bias=False)
        self.down_proj = nn.Linear(hidden_size, units, bias=False)

    def forward(self, x, cache=None):
        # with a cache, the serving rung's products apply (shape-stable on
        # baseline, the int8 side table on int8)
        gate = _serving_dense(x, self.gate_proj.weight, cache)
        up = _serving_dense(x, self.up_proj.weight, cache)
        return _serving_dense(_ops.activation(gate, "silu") * up,
                              self.down_proj.weight, cache)


class LlamaBlock(nn.Module):
    def __init__(self, units, hidden_size, num_heads, num_kv_heads,
                 norm_eps=1e-5):
        super().__init__()
        self.attn_norm = RMSNorm(units, epsilon=norm_eps)
        self.attention = LlamaAttention(units, num_heads, num_kv_heads)
        self.ffn_norm = RMSNorm(units, epsilon=norm_eps)
        self.ffn = LlamaFFN(units, hidden_size)

    def forward(self, x, cache=None, start_pos=None):
        stable = _stable(cache)
        x = x + self.attention(self.attn_norm(x, stable=stable), cache=cache,
                               start_pos=start_pos)
        return x + self.ffn(self.ffn_norm(x, stable=stable), cache=cache)


class LlamaModel(nn.Module):
    """Decoder-only LM: logits of a whole sequence (training), or through
    per-layer KV rings (serving).

    ``remat=True``: inside a ``parallel.ShardedTrainer`` step, each layer
    runs under ``torch.utils.checkpoint`` and is recomputed in the backward
    instead of keeping its activations. Elsewhere (an eager
    ``gluon.Trainer``, serving) the plain loop runs, as the JAX package
    recomputes only inside a traced step. ``layer_barrier=True`` (only
    with ``remat=True``) is accepted and does nothing: in the JAX package
    it is an XLA scheduling fence that keeps a layer's weight gathers and
    casts from moving ahead of the previous layer, and eager PyTorch runs
    each layer's ops in order anyway.
    """

    # ShardedTrainer protocol: under remat the model casts its parameters
    # to the AMP dtype at use inside each recomputed layer (``_amp_dtype``,
    # set by the trainer for its step) instead of the trainer casting the
    # whole model, so no low-precision copy of the weights lives across
    # the step
    supports_inner_amp = True

    def __init__(self, vocab_size=32000, units=4096, hidden_size=11008,
                 num_layers=32, num_heads=32, num_kv_heads=None,
                 norm_eps=1e-5, tie_embeddings=False, remat=False,
                 layer_barrier=False):
        super().__init__()
        if layer_barrier and not remat:
            raise MXNetError(
                "layer_barrier=True requires remat=True (the barrier "
                "lives inside the per-layer recompute)")
        self._remat = remat
        self._layer_barrier = layer_barrier
        # set by ShardedTrainer for the duration of its step
        self._amp_dtype = None
        self._in_step = False
        self._units = units
        self._tie = tie_embeddings
        self.embed = nn.Embedding(vocab_size, units)
        self._blocks = []
        for i in range(num_layers):
            blk = LlamaBlock(units, hidden_size, num_heads, num_kv_heads,
                             norm_eps)
            self._blocks.append(blk)
            self.add_module(f"layer{i}", blk)
        self.norm = RMSNorm(units, epsilon=norm_eps)
        if not tie_embeddings:
            self.lm_head = nn.Linear(units, vocab_size, bias=False)

    def forward(self, input_ids, cache=None, start_pos=None, last_idx=None):
        """Logits of ``input_ids`` (B, T): with no ``cache``, causal over
        the sequence from position 0; with one, at positions
        ``start_pos[b] + t`` through its KV rings. (B, T, vocab), or
        (B, vocab) at the positions ``last_idx`` (B,) when it is given.
        Picking the rows before the final norm and LM head, instead of
        after them as the JAX package does, gives the same values (both act
        per position) and keeps a prefill from computing T x vocab logits
        it throws away."""
        x = self.embed(input_ids.to(torch.long))
        stable = _stable(cache)
        if cache is None and self._remat and self._in_step:
            x = self._recompute_layers(x)
        else:
            for i, blk in enumerate(self._blocks):
                x = blk(x, cache=None if cache is None else cache.layer(i),
                        start_pos=start_pos)
                if stable:  # where the JAX package fences its layers
                    x = _ops.fusion_fence(x)
        if last_idx is not None:
            x = _ops.gather_positions(x, last_idx)
        x = self.norm(x, stable=stable)
        w = self.embed.weight if self._tie else self.lm_head.weight
        return _serving_dense(x, w, cache)

    def _recompute_layers(self, x):
        """The layers, each recomputed in the backward
        (``torch.utils.checkpoint``). With ``_amp_dtype`` set, the
        activation enters the first layer in that dtype and each layer
        runs on low-precision copies of its floating parameters, made at
        use inside the checkpoint (so they are freed after the layer's
        forward and made again in its backward) and differentiable back to
        the f32 masters; the final norm and the head then run on the
        masters after ``x.float()``."""
        amp = self._amp_dtype
        if amp is not None:
            x = x.to(amp)

        def layer(blk, h):
            if amp is None:
                return blk(h)
            params = {n: p.to(amp) if p.is_floating_point() else p
                      for n, p in blk.named_parameters()}
            return torch.func.functional_call(blk, params, (h,))

        for blk in self._blocks:
            x = _checkpoint(layer, blk, x, use_reentrant=False)
        return x.float() if amp is not None else x


# canonical configs (vocab 32000 for llama-2 sizes, 128256 for llama-3-8b)
_LLAMA_CONFIGS = {
    "llama_tiny_test": dict(units=64, hidden_size=128, num_layers=2,
                            num_heads=4, num_kv_heads=2, vocab_size=256),
    "llama_serve_12l_test": dict(units=128, hidden_size=256, num_layers=12,
                                 num_heads=4, num_kv_heads=2,
                                 vocab_size=512),
    "llama2_7b": dict(units=4096, hidden_size=11008, num_layers=32,
                      num_heads=32, num_kv_heads=32, vocab_size=32000),
    "llama3_8b": dict(units=4096, hidden_size=14336, num_layers=32,
                      num_heads=32, num_kv_heads=8, vocab_size=128256),
}

_INIT_SCALE = 0.07  # MXNet's default initializer: Uniform(-0.07, 0.07)


def get_llama(config="llama3_8b", device=None, trainable=False,
              **overrides):
    """Build a :class:`LlamaModel` from a named config on ``device`` (the
    GPU unless ``"cpu"`` is asked for) with seeded random weights: every
    weight matrix uniform in [-0.07, 0.07] from the device's
    ``mxnet_tpu_torch.random`` stream, every norm gain 1. The parameters
    are made on the device directly, so an 8B model never passes through
    host memory. The model is in eval mode with gradients off, for
    serving; ``trainable=True`` gives it in train mode with gradients on,
    for ``gluon.Trainer``."""
    if config not in _LLAMA_CONFIGS:
        raise MXNetError(f"unknown llama config {config!r}; options "
                         f"{sorted(_LLAMA_CONFIGS)}")
    dev = _device.resolve(device)
    cfg = dict(_LLAMA_CONFIGS[config])
    cfg.update(overrides)
    with torch.device("meta"):
        model = LlamaModel(**cfg)
    model.to_empty(device=dev)
    gen = _rng.generator(dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            else:
                p.uniform_(-_INIT_SCALE, _INIT_SCALE, generator=gen)
            p.requires_grad_(trainable)
    return model.train(trainable)


def load_reference_params(model, params):
    """Copy weights keyed by the JAX package's ``collect_params()`` names
    (``{name: numpy array}``) into ``model``, a Llama, BERT or Transformer
    of the port. A tied parameter (the Transformer's shared embedding)
    answers to each of its names, as in the JAX package, and its entries
    must be equal. Raises :class:`MXNetError` on a missing, unused or
    wrongly shaped entry. Returns ``model``."""
    own = dict(model.named_parameters(remove_duplicate=False))
    missing = sorted(set(own) - set(params))
    unused = sorted(set(params) - set(own))
    if missing or unused:
        raise MXNetError(f"load_reference_params: missing {missing}, "
                         f"unused {unused}")
    first = {}  # id of a parameter -> the first name it was loaded under
    with torch.no_grad():
        for name, p in own.items():
            arr = _onp.asarray(params[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise MXNetError(
                    f"load_reference_params: {name} has shape "
                    f"{tuple(arr.shape)}, the model wants {tuple(p.shape)}")
            tied = first.setdefault(id(p), name)
            if tied != name:
                if not _onp.array_equal(arr, _onp.asarray(params[tied])):
                    raise MXNetError(
                        f"load_reference_params: {name} and {tied} are one "
                        "tied parameter, but their entries differ")
                continue
            p.copy_(torch.tensor(arr))
    return model
