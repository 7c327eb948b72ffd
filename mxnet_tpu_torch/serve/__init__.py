"""Inference serving of the port (counterpart of ``mxnet_tpu/serve``): the
bucketed session with its circuit breaker and watchdog, the CUDA-graph
session, the KV-cache generator (ring or paged, single- or multi-step),
speculative decoding, the paged pool with its prefix cache, the admission
queue, serving metrics, the continuous-batching engine, the multi-tenant
model registry, and the fleet layer (replicas behind a router)."""
from __future__ import annotations

from .batcher import PRIORITIES, DynamicBatcher, TokenBucket
from .engine import (DeadlineExceeded, GraphSession, InferenceSession,
                     PoolExhausted, ServeError, ServiceUnavailable,
                     pick_bucket)
from .fleet import QueueDepthPolicy, Router, fleet_stats
from .generate import (Generator, KVCache, SpeculativeGenerator,
                       resolve_decode_path, sample_tokens)
from .kv_blocks import PagedKVPool, resolve_page_size
from .metrics import ServeMetrics, percentile
from .prefix_cache import PrefixCache
from .replica import Replica
from .scheduler import ContinuousEngine
from .tenancy import ModelRegistry, registry_stats

__all__ = [
    "InferenceSession", "GraphSession", "DynamicBatcher", "Generator",
    "SpeculativeGenerator", "KVCache", "ServeMetrics", "ServeError",
    "ServiceUnavailable", "DeadlineExceeded", "PoolExhausted",
    "TokenBucket", "PRIORITIES", "ContinuousEngine", "PagedKVPool",
    "resolve_page_size", "PrefixCache", "sample_tokens", "pick_bucket",
    "percentile", "resolve_decode_path", "ModelRegistry", "registry_stats",
    "Router", "Replica", "QueueDepthPolicy", "fleet_stats",
]
