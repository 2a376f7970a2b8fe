"""Serving: paged KV-cache with Scavenger+-style GC + continuous batching."""

from .kvcache import PagedCacheConfig, PagedKVCache
from .scheduler import Request, ServeConfig, ServeLoop

__all__ = ["PagedCacheConfig", "PagedKVCache", "Request", "ServeConfig",
           "ServeLoop"]
