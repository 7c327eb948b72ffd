"""Inference serving of the port: the bucketed session, the CUDA-graph
session, the KV-cache generator (ring or paged, single- or multi-step),
the paged pool with its prefix cache, the admission queue, serving
metrics and the continuous-batching engine (counterparts of
``mxnet_tpu/serve/engine.py``, ``generate.py``, ``kv_blocks.py``,
``prefix_cache.py``, ``batcher.py``, ``metrics.py`` and ``scheduler.py``).
Speculative decoding, tenancy and the fleet layer come in later slices."""
from __future__ import annotations

from .batcher import PRIORITIES, DynamicBatcher, TokenBucket
from .engine import (DeadlineExceeded, GraphSession, InferenceSession,
                     PoolExhausted, ServeError, ServiceUnavailable,
                     pick_bucket)
from .generate import Generator, KVCache, resolve_decode_path, sample_tokens
from .kv_blocks import PagedKVPool, resolve_page_size
from .metrics import ServeMetrics, percentile
from .prefix_cache import PrefixCache
from .scheduler import ContinuousEngine

__all__ = [
    "InferenceSession", "GraphSession", "DynamicBatcher", "Generator",
    "KVCache", "ServeMetrics", "ServeError", "ServiceUnavailable",
    "DeadlineExceeded", "PoolExhausted", "TokenBucket", "PRIORITIES",
    "ContinuousEngine", "PagedKVPool", "resolve_page_size", "PrefixCache",
    "sample_tokens", "pick_bucket", "percentile", "resolve_decode_path",
]
