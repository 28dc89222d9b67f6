"""Serving: the continuous-batching engine over a paged KV cache."""

from .engine import Completion, Request, ServedResult, ServingEngine

__all__ = ["Completion", "Request", "ServedResult", "ServingEngine"]
