"""Transformer building blocks and the encoder-decoder MT model as
``torch.nn`` modules (counterpart of ``mxnet_tpu/models/transformer.py``).

Every attention runs through ``ops.nn.attention``: on CUDA tensors the
hand-written flash kernels (``csrc/flash_attention.cu``) forward and
backward, with ``causal`` and the (B,) ``valid_length`` key lengths masked
inside the kernels; on the CPU their plain versions. Everything else is
dense products and elementwise ops that PyTorch runs.

Module and parameter names follow the JAX package's, so
``named_parameters(remove_duplicate=False)`` yields exactly its
``collect_params()`` names (``enc_layers.0.attention.query_proj.weight``,
``dec0.ffn.ffn_1.bias``, ...) and ``models.load_reference_params`` carries
its weights across. The port does not defer shapes: every layer is built
with its input width. :class:`Transformer` builds its layers on ``meta``
and makes them on ``device`` (the GPU unless ``"cpu"`` is asked for) with
seeded MXNet default values (:func:`_materialize`).

Sharding: :func:`transformer_sharding_rules` gives the JAX package's
Megatron table in the port's form, ``(regex, spec)`` with ``spec`` a tuple
of mesh axis names, for ``parallel.ShardingRules``, which keeps them on
one device without applying them.
"""
from __future__ import annotations

import functools
import math

import numpy as _onp
import torch
from torch import nn

from .. import device as _device
from .. import random as _rng
from ..base import MXNetError
from ..gluon.nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from ..ops import nn as _ops

_INIT_SCALE = 0.07  # MXNet's default initializer: Uniform(-0.07, 0.07)


def _materialize(module, device):
    """Make every parameter of ``module`` that is still on ``meta`` on
    ``device`` with MXNet's default values, as ``initialize()`` gives them
    in the JAX package: ``gamma`` 1, ``bias`` and ``beta`` 0, every other
    weight uniform in [-0.07, 0.07] from the device's seeded stream
    (``mxnet_tpu_torch.random``). Parameters already made (a backbone
    under a new head) keep their values. Returns ``module``."""
    dev = _device.resolve(device)
    fresh = []
    for mod in module.modules():   # a shared (tied) module comes once
        names = [n for n, p in mod.named_parameters(recurse=False)
                 if p.is_meta]
        if names:
            mod.to_empty(device=dev, recurse=False)
            fresh += [(n, getattr(mod, n)) for n in names]
    gen = _rng.generator(dev)
    with torch.no_grad():
        for name, p in fresh:
            if name == "gamma":
                p.fill_(1.0)
            elif name in ("bias", "beta"):
                p.zero_()
            else:
                p.uniform_(-_INIT_SCALE, _INIT_SCALE, generator=gen)
    return module


class MultiHeadAttention(nn.Module):
    """Multi-head scaled-dot-product attention through the flash
    kernels."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False):
        super().__init__()
        if units % num_heads != 0:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal

        def proj():
            return Dense(units, flatten=False, use_bias=use_bias,
                         in_units=units)

        self.query_proj = proj()
        self.key_proj = proj()
        self.value_proj = proj()
        self.out_proj = proj()
        self.dropout = Dropout(dropout) if dropout else None

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self._num_heads, -1).transpose(1, 2)

    def forward(self, query, key=None, value=None, mask=None,
                valid_length=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.query_proj(query))
        k = self._split(self.key_proj(key))
        v = self._split(self.value_proj(value))
        out = _ops.attention(q, k, v, mask=mask, causal=self._causal,
                             valid_length=valid_length)
        b, h, t, d = out.shape
        out = self.out_proj(out.transpose(1, 2).reshape(b, t, h * d))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(nn.Module):
    """The transformer FFN: expand, activation, contract."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units)
        self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size)
        self._activation = activation
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.ffn_2(_ops.activation(self.ffn_1(x), self._activation))
        if self.dropout is not None:
            h = self.dropout(h)
        return h


class TransformerEncoderCell(nn.Module):
    """Post-norm (BERT-style) or pre-norm encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, activation="gelu", layer_norm_eps=1e-12):
        super().__init__()
        self._pre_norm = pre_norm
        self.attention = MultiHeadAttention(units, num_heads, dropout=dropout)
        self.ffn = PositionwiseFFN(units, hidden_size, activation=activation,
                                   dropout=dropout)
        self.layer_norm_att = LayerNorm(epsilon=layer_norm_eps,
                                        in_channels=units)
        self.layer_norm_ffn = LayerNorm(epsilon=layer_norm_eps,
                                        in_channels=units)

    def forward(self, x, mask=None, valid_length=None):
        # each sublayer's dropout lives inside it, after its output
        # projection: once a sublayer
        if self._pre_norm:
            x = x + self.attention(self.layer_norm_att(x), mask=mask,
                                   valid_length=valid_length)
            return x + self.ffn(self.layer_norm_ffn(x))
        h = self.attention(x, mask=mask, valid_length=valid_length)
        x = self.layer_norm_att(x + h)
        return self.layer_norm_ffn(x + self.ffn(x))


class TransformerDecoderCell(nn.Module):
    """Decoder layer: causal self-attention, cross-attention over the
    encoder's memory, FFN (post-norm)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="relu", layer_norm_eps=1e-5):
        super().__init__()
        self.self_attention = MultiHeadAttention(units, num_heads,
                                                 dropout=dropout, causal=True)
        self.cross_attention = MultiHeadAttention(units, num_heads,
                                                  dropout=dropout)
        self.ffn = PositionwiseFFN(units, hidden_size, activation=activation,
                                   dropout=dropout)
        self.layer_norm_self = LayerNorm(epsilon=layer_norm_eps,
                                         in_channels=units)
        self.layer_norm_cross = LayerNorm(epsilon=layer_norm_eps,
                                          in_channels=units)
        self.layer_norm_ffn = LayerNorm(epsilon=layer_norm_eps,
                                        in_channels=units)

    def forward(self, x, mem, mem_mask=None, mem_valid_length=None):
        x = self.layer_norm_self(x + self.self_attention(x))
        x = self.layer_norm_cross(
            x + self.cross_attention(x, mem, mem, mask=mem_mask,
                                     valid_length=mem_valid_length))
        return self.layer_norm_ffn(x + self.ffn(x))


@functools.lru_cache(maxsize=32)
def _sinusoid_table(t, units):
    # the JAX package's numpy table, copied: float64 angles rounded to f32
    pos = _onp.arange(t)[:, None]
    dim = _onp.arange(0, units, 2)[None]
    angle = pos / _onp.power(10000.0, dim / units)
    enc = _onp.zeros((t, units), dtype="float32")
    enc[:, 0::2] = _onp.sin(angle)
    enc[:, 1::2] = _onp.cos(angle[:, :units // 2])  # odd units: cos is shorter
    return enc


@functools.lru_cache(maxsize=32)
def _sinusoid_on(t, units, device):
    # one copy on each device; a normal tensor even when first asked for
    # under inference_mode, so training can use it afterwards
    with torch.inference_mode(False):
        return torch.from_numpy(_sinusoid_table(t, units)).to(device)


class PositionalEmbedding(nn.Module):
    """Learned positions (BERT: ``weight`` (max_length, units)) or the
    sinusoid table (MT transformer), added to ``x`` (B, T, units). The
    table is f32, so it promotes a bf16 ``x`` to f32, as ``jnp`` does."""

    def __init__(self, units, max_length=512, learned=True):
        super().__init__()
        self._units = units
        self._max_length = max_length
        self._learned = learned
        if learned:
            self.weight = nn.Parameter(torch.empty(max_length, units))

    def forward(self, x):
        t = x.shape[1]
        if t > self._max_length:
            raise MXNetError(f"sequence length {t} exceeds max_length "
                             f"{self._max_length}")
        if self._learned:
            return x + self.weight[:t]
        return x + _sinusoid_on(t, self._units, x.device)


class Transformer(nn.Module):
    """Encoder-decoder MT transformer, the base configuration by default
    (Vaswani et al. 2017). Built on ``device`` (the GPU unless ``"cpu"``
    is asked for) with seeded MXNet default values. ``tie_embeddings``
    shares one embedding between source and target (one ``nn.Parameter``
    under both names, as in the JAX package); the output projection
    ``proj`` is its own."""

    def __init__(self, src_vocab_size, tgt_vocab_size=None, units=512,
                 hidden_size=2048, num_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dropout=0.1, max_length=1024,
                 tie_embeddings=False, device=None):
        super().__init__()
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        self._units = units
        with torch.device("meta"):
            self.src_embed = Embedding(src_vocab_size, units)
            self.tgt_embed = (self.src_embed if tie_embeddings
                              else Embedding(tgt_vocab_size, units))
            self.pos_embed = PositionalEmbedding(units, max_length,
                                                 learned=False)
            self.enc_layers = HybridSequential()
            for _ in range(num_encoder_layers):
                self.enc_layers.add(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    activation="relu", layer_norm_eps=1e-5))
            self._dec_layers = []
            for i in range(num_decoder_layers):
                cell = TransformerDecoderCell(units, hidden_size, num_heads,
                                              dropout=dropout)
                self._dec_layers.append(cell)
                self.add_module(f"dec{i}", cell)
            self.proj = Dense(tgt_vocab_size, flatten=False, in_units=units)
        self._scale = math.sqrt(units)
        _materialize(self, device)

    def encode(self, src, src_valid_length=None):
        # the (B,) lengths go to the attention op: the flash kernels mask
        # them in-kernel, never forming a (T, T) mask
        x = self.pos_embed(self.src_embed(src) * self._scale)
        for layer in self.enc_layers:
            x = layer(x, valid_length=src_valid_length)
        return x

    def decode(self, tgt, mem, src_valid_length=None):
        y = self.pos_embed(self.tgt_embed(tgt) * self._scale)
        for cell in self._dec_layers:
            y = cell(y, mem, mem_valid_length=src_valid_length)
        return self.proj(y)

    def forward(self, src, tgt, src_valid_length=None):
        mem = self.encode(src, src_valid_length)
        return self.decode(tgt, mem, src_valid_length)


def transformer_sharding_rules(prefix=""):
    """The JAX package's tensor-parallel table for transformer parameters
    (the Megatron layout: q/k/v and the FFN's expand shard their output
    dim over ``tp``, the output projection and the contract their input
    dim), as ``(regex, spec)`` pairs with ``spec`` a tuple of mesh axis
    names (``()`` is replicated), for ``parallel.ShardingRules``."""
    return [
        (prefix + r"(query|key|value)_proj\.weight", ("tp", None)),
        (prefix + r"(query|key|value)_proj\.bias", ("tp",)),
        (prefix + r"out_proj\.weight", (None, "tp")),
        (prefix + r"ffn_1\.weight", ("tp", None)),
        (prefix + r"ffn_1\.bias", ("tp",)),
        (prefix + r"ffn_2\.weight", (None, "tp")),
        (prefix + r"(?:embed.*weight|.*embedding.*weight)", ("tp", None)),
        (prefix + r"(?:.*(gamma|beta|bias)$)", ()),
    ]
