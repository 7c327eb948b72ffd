"""BERT as ``torch.nn`` modules (counterpart of ``mxnet_tpu/models/bert.py``).

Devlin et al. 1810.04805: learned word, position and segment embeddings,
a post-norm transformer encoder, a pooler, and the MLM + NSP heads. Every
encoder layer's attention runs the flash kernels through
``ops.nn.attention``, with the (B,) ``valid_length`` masked in-kernel.

Parameter names follow the JAX package's ``collect_params()``
(``bert.encoder.layer0.attention.query_proj.weight``, ...), so
``models.load_reference_params`` carries its weights across. The MLM
decoder of :class:`BERTForPretrain` is the word embedding's own
``nn.Parameter``, never a copy, so its gradient is the sum of both uses.

:func:`get_bert_model` and :class:`BERTModel` build on ``device`` (the GPU
unless ``"cpu"`` is asked for) with seeded MXNet default values; a head
(:class:`BERTForPretrain`, :class:`BERTClassifier`) makes its own
parameters on its backbone's device. :class:`BERTStep` is the
single-input wrapper the JAX package's callers write (``bench.py``'s
``PretrainStep``, ``examples/bert_finetune.py``'s ``Step``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops import nn as _ops
from .transformer import (PositionalEmbedding, TransformerEncoderCell,
                          _materialize, transformer_sharding_rules)


class BERTEncoder(nn.Module):
    """``num_layers`` post-norm GELU encoder cells, named ``layer{i}``."""

    def __init__(self, units, hidden_size, num_layers, num_heads,
                 dropout=0.1, layer_norm_eps=1e-12):
        super().__init__()
        self._layers = []
        for i in range(num_layers):
            cell = TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                pre_norm=False, activation="gelu",
                layer_norm_eps=layer_norm_eps)
            self._layers.append(cell)
            self.add_module(f"layer{i}", cell)

    def forward(self, x, mask=None, valid_length=None):
        for layer in self._layers:
            x = layer(x, mask=mask, valid_length=valid_length)
        return x


class BERTModel(nn.Module):
    """Backbone: returns ``(sequence_output, pooled_output)``."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, token_types=2,
                 dropout=0.1, layer_norm_eps=1e-12, device=None):
        super().__init__()
        self._units = units
        with torch.device("meta"):
            self.word_embed = Embedding(vocab_size, units)
            self.token_type_embed = Embedding(token_types, units)
            self.pos_embed = PositionalEmbedding(units, max_length,
                                                 learned=True)
            self.embed_layer_norm = LayerNorm(epsilon=layer_norm_eps,
                                              in_channels=units)
            self.embed_dropout = Dropout(dropout)
            self.encoder = BERTEncoder(units, hidden_size, num_layers,
                                       num_heads, dropout=dropout,
                                       layer_norm_eps=layer_norm_eps)
            self.pooler = Dense(units, activation="tanh", flatten=False,
                                in_units=units)
        _materialize(self, device)

    def forward(self, inputs, token_types=None, valid_length=None):
        x = self.word_embed(inputs)
        if token_types is None:
            token_types = torch.zeros_like(inputs)
        x = self.pos_embed(x + self.token_type_embed(token_types))
        x = self.embed_dropout(self.embed_layer_norm(x))
        # the (B,) lengths go to the attention op: the flash kernels mask
        # in-kernel instead of forming a (T, T) mask
        seq = self.encoder(x, valid_length=valid_length)
        return seq, self.pooler(seq[:, 0])


def _device_of(module):
    return next(module.parameters()).device


class BERTForPretrain(nn.Module):
    """MLM + NSP heads over the backbone (the pretraining objective)."""

    def __init__(self, bert: BERTModel):
        super().__init__()
        self.bert = bert
        units = bert._units
        with torch.device("meta"):
            self.mlm_dense = Dense(units, activation="gelu", flatten=False,
                                   in_units=units)
            self.mlm_norm = LayerNorm(epsilon=1e-12, in_channels=units)
            self.nsp = Dense(2, flatten=False, in_units=units)
        _materialize(self, _device_of(bert))

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        h = self.mlm_norm(self.mlm_dense(seq))
        # the decoder is the word embedding itself (BERT's weight tying)
        w = self.bert.word_embed.weight
        mlm_scores = _ops.fully_connected(h, w, None, num_hidden=w.shape[0],
                                          no_bias=True, flatten=False)
        return mlm_scores, self.nsp(pooled)


class BERTClassifier(nn.Module):
    """Sentence(-pair) classification head (fine-tuning)."""

    def __init__(self, bert: BERTModel, num_classes=2, dropout=0.1):
        super().__init__()
        self.bert = bert
        with torch.device("meta"):
            self.dropout = Dropout(dropout)
            self.classifier = Dense(num_classes, in_units=bert._units)
        _materialize(self, _device_of(bert))

    def forward(self, inputs, token_types=None, valid_length=None):
        _, pooled = self.bert(inputs, token_types, valid_length)
        return self.classifier(self.dropout(pooled))


class BERTStep(nn.Module):
    """Single-input wrapper over a BERT model (``BERTForPretrain``,
    ``BERTClassifier``, ``BERTModel``): derives ``valid_length =
    (tokens != 0).sum(1)`` from the pad mask inside the block, so a
    session or a trainer hands it one tensor of token ids."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens):
        return self.model(tokens, valid_length=(tokens != 0).sum(1))


_BERT_CONFIGS = {
    "bert_12_768_12": dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
    "bert_24_1024_16": dict(units=1024, hidden_size=4096, num_layers=24,
                            num_heads=16),
}
_BERT_CONFIGS["bert_base"] = _BERT_CONFIGS["bert_12_768_12"]
_BERT_CONFIGS["bert_large"] = _BERT_CONFIGS["bert_24_1024_16"]


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   max_length=512, dropout=0.1, pretrained=False,
                   device=None, **kwargs):
    """A BERT backbone by config name (GluonNLP naming) on ``device`` (the
    GPU unless ``"cpu"`` is asked for), with seeded random weights;
    ``kwargs`` override the config. Nothing is downloaded: weights come
    from a seed or from ``load_reference_params``."""
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; use "
                         "load_reference_params")
    if model_name not in _BERT_CONFIGS:
        raise MXNetError(f"unknown bert config {model_name!r}; options "
                         f"{sorted(_BERT_CONFIGS)}")
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, device=device, **cfg)


def bert_sharding_rules():
    """The transformer table plus replication of the small heads (pooler,
    NSP, the MLM dense and norm), in the port's ``(regex, spec)`` form."""
    return transformer_sharding_rules() + [
        (r"(pooler|nsp|mlm_dense|mlm_norm)\.", ()),
    ]
