"""Serving: the continuous-batching engine over a paged KV cache, and
the weight watcher behind its hot-swap."""

from .engine import Completion, Request, ServedResult, ServingEngine
from .hotswap import WeightWatcher
from .kv_cache import PageAllocator, make_pool

__all__ = ["Completion", "Request", "ServedResult", "ServingEngine",
           "WeightWatcher", "PageAllocator", "make_pool"]
