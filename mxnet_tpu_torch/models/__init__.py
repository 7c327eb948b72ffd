"""Model families of the port: the Llama decoder, BERT and the
Transformer (counterpart of ``mxnet_tpu/models``)."""
from __future__ import annotations

from . import bert, llama, transformer
from .bert import (BERTClassifier, BERTEncoder, BERTForPretrain, BERTModel,
                   BERTStep, bert_sharding_rules, get_bert_model)
from .llama import LlamaModel, get_llama, load_reference_params
from .transformer import (MultiHeadAttention, PositionwiseFFN, Transformer,
                          TransformerDecoderCell, TransformerEncoderCell,
                          transformer_sharding_rules)

__all__ = ["bert", "llama", "transformer", "BERTClassifier", "BERTEncoder",
           "BERTForPretrain", "BERTModel", "BERTStep", "LlamaModel",
           "MultiHeadAttention", "PositionwiseFFN", "Transformer",
           "TransformerDecoderCell", "TransformerEncoderCell",
           "bert_sharding_rules", "get_bert_model", "get_llama",
           "load_reference_params", "transformer_sharding_rules"]
