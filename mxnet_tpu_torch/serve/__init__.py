"""Inference serving of the port: the bucketed session, the CUDA-graph
session, the KV-cache generator (ring or paged, single- or multi-step) and
the paged pool with its prefix cache (counterparts of
``mxnet_tpu/serve/engine.py``, ``generate.py``, ``kv_blocks.py`` and
``prefix_cache.py``). Batching, continuous batching, speculative decoding,
the fleet layer and serving metrics come in later slices."""
from __future__ import annotations

from .engine import (GraphSession, InferenceSession, PoolExhausted,
                     ServeError, ServiceUnavailable, pick_bucket)
from .generate import Generator, KVCache, resolve_decode_path, sample_tokens
from .kv_blocks import PagedKVPool, resolve_page_size
from .prefix_cache import PrefixCache

__all__ = [
    "InferenceSession", "GraphSession", "Generator", "KVCache",
    "PagedKVPool", "PrefixCache", "ServeError", "ServiceUnavailable",
    "PoolExhausted", "sample_tokens", "pick_bucket", "resolve_decode_path",
    "resolve_page_size",
]
