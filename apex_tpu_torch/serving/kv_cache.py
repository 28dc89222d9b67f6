"""Block-paged KV cache — counterpart of ``apex_tpu/serving/kv_cache.py``.

* the **pool** is two device tensors ``[n_layers, n_pages, page_size,
  n_kv_heads, head_dim]`` (k and v), updated in place by the scatters;
* the **page table** is host state (:class:`PageAllocator`): a free
  list plus per-sequence page lists.  Page 0 is the trash page — dead
  batch slots and the padded tail of short sequences point there, so a
  masked lane can never corrupt a live page;
* :func:`gather_views` / :func:`scatter_prefill` / :func:`scatter_token`
  bridge the pool and the dense ``[S, bucket, n_kv, head_dim]`` views the
  GPT incremental forward consumes, in plain torch indexing.

The int8 ``QuantPool`` waits for the quantization slice.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PageAllocator", "TRASH_PAGE", "make_pool", "gather_views",
           "scatter_prefill", "scatter_token", "kv_bytes_per_token"]

#: page id 0 is the trash page: dead slots and table padding point at it.
TRASH_PAGE = 0


def _model_kv_dims(model) -> Tuple[int, int, int]:
    n_kv = model.num_kv_heads or model.num_heads
    return model.num_layers, n_kv, model.hidden_size // model.num_heads


def kv_bytes_per_token(model) -> int:
    """Device bytes ONE cached token costs across all layers (k + v)."""
    n_layers, n_kv, head_dim = _model_kv_dims(model)
    return 2 * n_layers * n_kv * head_dim * model.dtype.itemsize


def make_pool(model, n_pages: int, page_size: int, device=None):
    """Zeroed ``(pool_k, pool_v)``, each ``[n_layers, n_pages, page_size,
    n_kv_heads, head_dim]`` in the model's compute dtype on ``device``
    (default: the model's)."""
    n_layers, n_kv, head_dim = _model_kv_dims(model)
    dev = model.device if device is None else device
    shape = (n_layers, n_pages, page_size, n_kv, head_dim)
    return (torch.zeros(shape, dtype=model.dtype, device=dev),
            torch.zeros(shape, dtype=model.dtype, device=dev))


def gather_views(pool_k, pool_v, tables):
    """Dense per-layer cache views from the page pool.

    ``tables``: ``[S, n_pages_b]`` integer page ids.  Returns a list of
    per-layer ``(k, v)`` pairs, each ``[S, n_pages_b * page_size, n_kv,
    head_dim]`` — fresh tensors (the gather copies), exactly the
    ``kv_caches`` the GPT incremental forward takes."""
    n_layers, _, page_size, n_kv, head_dim = pool_k.shape
    s, n_pages_b = tables.shape
    tables = tables.to(device=pool_k.device, dtype=torch.long)

    def dense(pool):
        return pool[:, tables].reshape(n_layers, s, n_pages_b * page_size,
                                       n_kv, head_dim)

    kd, vd = dense(pool_k), dense(pool_v)
    return [(kd[i], vd[i]) for i in range(n_layers)]


def scatter_prefill(pool, pages, dense):
    """Write one sequence's prefilled cache into its pages, in place.

    ``pages``: ``[n_pages_b]`` page ids; ``dense``: ``[n_layers, bucket,
    n_kv, head_dim]`` (the batch-1 view the prefill forward produced).
    Returns ``pool``."""
    n_layers, _, page_size, n_kv, head_dim = pool.shape
    pages = pages.to(device=pool.device, dtype=torch.long)
    paged = dense.reshape(n_layers, pages.shape[0], page_size, n_kv,
                          head_dim)
    pool[:, pages] = paged.to(pool.dtype)
    return pool


def scatter_token(pool, page_ids, offsets, tok):
    """Write one fresh token's k or v per batch slot, in place.

    ``page_ids``/``offsets``: ``[S]`` (page and in-page offset of each
    slot's current position — dead slots point at the trash page);
    ``tok``: ``[n_layers, S, n_kv, head_dim]``.  Returns ``pool``."""
    page_ids = page_ids.to(device=pool.device, dtype=torch.long)
    offsets = offsets.to(device=pool.device, dtype=torch.long)
    pool[:, page_ids, offsets] = tok.to(pool.dtype)
    return pool


class PageAllocator:
    """Host-side page accounting: a free list over ``n_pages - 1`` real
    pages (page 0 is the trash page and never allocated).  Thread-safe;
    :meth:`alloc` is all-or-nothing so a request can never be admitted
    half-resident."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the trash page), "
                             f"got {n_pages}")
        self.n_pages = int(n_pages)
        self._free = list(range(n_pages - 1, TRASH_PAGE, -1))
        self._lock = threading.Lock()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def total_pages(self) -> int:
        """Allocatable pages (the trash page excluded)."""
        return self.n_pages - 1

    @property
    def occupancy_pct(self) -> float:
        """Percent of allocatable pages currently held by sequences."""
        total = self.total_pages
        return 100.0 * (total - len(self._free)) / total if total else 0.0

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, or None when fewer are free (all-or-nothing)."""
        with self._lock:
            if n > len(self._free):
                return None
            return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE:
                    raise ValueError("attempted to free the trash page")
                if p in self._free:
                    raise ValueError(f"double free of page {p}")
                self._free.append(p)

    def padded_row(self, pages: Sequence[int], width: int) -> np.ndarray:
        """One page-table row padded to ``width`` with the trash page.
        A sequence holding MORE pages than the view is truncated: a
        long-bucket sequence still early in its life decodes through a
        smaller bucket's table, whose view covers exactly the first
        ``width`` pages (its live positions all fit there)."""
        row = np.full((width,), TRASH_PAGE, np.int64)
        n = min(len(pages), width)
        row[:n] = np.asarray(pages[:n], np.int64)
        return row
