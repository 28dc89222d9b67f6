"""Serving: the continuous-batching engine over a paged KV cache, and
the weight watcher behind its hot-swap."""

from .engine import Completion, Request, ServedResult, ServingEngine
from .hotswap import WeightWatcher

__all__ = ["Completion", "Request", "ServedResult", "ServingEngine",
           "WeightWatcher"]
