"""Serving: the fixed-slot engine over ring KV caches, and paged serving
(the KV pool allocator, the prefix cache and the continuous-batching
engine)."""
from .engine import PagedServeEngine, Request, ServeEngine
from .kv_pool import KVPool, OutOfPagesError
from .prefix_cache import PrefixCache, PrefixMatch

__all__ = ["KVPool", "OutOfPagesError", "PagedServeEngine", "PrefixCache", "PrefixMatch",
           "Request", "ServeEngine"]
