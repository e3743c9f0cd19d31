"""Paged serving: the KV pool allocator and the continuous-batching engine."""
from .engine import PagedServeEngine, Request
from .kv_pool import KVPool, OutOfPagesError

__all__ = ["KVPool", "OutOfPagesError", "PagedServeEngine", "Request"]
