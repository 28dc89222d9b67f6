"""Models: the GPT decoder the serving path runs."""

from .gpt import GPT, GPTBlock, gpt2_small, gpt_tiny, init_cache

__all__ = ["GPT", "GPTBlock", "gpt2_small", "gpt_tiny", "init_cache"]
