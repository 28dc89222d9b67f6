"""Block-paged KV cache — counterpart of ``apex_tpu/serving/kv_cache.py``.

* the **pool** is two device tensors ``[n_layers, n_pages, page_size,
  n_kv_heads, head_dim]`` (k and v), updated in place by the scatters;
* the **page table** is host state (:class:`PageAllocator`): a free
  list plus per-sequence page lists.  Page 0 is the trash page — dead
  batch slots and the padded tail of short sequences point there, so a
  masked lane can never corrupt a live page;
* :func:`gather_views` / :func:`scatter_prefill` / :func:`scatter_token`
  bridge the pool and the dense ``[S, bucket, n_kv, head_dim]`` views the
  GPT incremental forward consumes, in plain torch indexing;
* an int8 pool (``make_pool(..., dtype=torch.int8)``) is a
  :class:`QuantPool` per half: int8 rows plus one fp32 scale per (token,
  head).  The scatters quantize on the way in, the gather dequantizes to
  the model's compute dtype, so the model never sees int8.  All of it is
  plain torch, as it is plain jnp in the JAX package.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PageAllocator", "QuantPool", "TRASH_PAGE", "make_pool",
           "gather_views", "scatter_prefill", "scatter_token",
           "kv_bytes_per_token", "pages_for_budget", "storage_dtype"]

#: page id 0 is the trash page: dead slots and table padding point at it.
TRASH_PAGE = 0


class QuantPool:
    """One int8 half of the KV pool: ``data`` int8 ``[n_layers, n_pages,
    page_size, n_kv, head_dim]`` and ``scale`` fp32 ``[n_layers, n_pages,
    page_size, n_kv]``, one symmetric absmax scale per cached row (4 bytes
    against ``head_dim`` saved).  ``shape`` is the dense view's, ``dtype``
    the dense view's dtype (what :func:`gather_views` hands the model);
    the storage dtype is ``data.dtype``."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype):
        self.data = data
        self.scale = scale
        self.out_dtype = out_dtype

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.out_dtype

    @property
    def device(self) -> torch.device:
        return self.data.device


def storage_dtype(pool) -> str:
    """The dtype a pool half stores (``"int8"`` for a :class:`QuantPool`),
    as the JAX package names it: the ``kv_cache_dtype`` label."""
    dt = pool.data.dtype if isinstance(pool, QuantPool) else pool.dtype
    return str(dt).replace("torch.", "")


def _model_kv_dims(model) -> Tuple[int, int, int]:
    n_kv = model.num_kv_heads or model.num_heads
    return model.num_layers, n_kv, model.hidden_size // model.num_heads


def kv_bytes_per_token(model, dtype=None) -> int:
    """Device bytes ONE cached token costs across all layers (k + v,
    the scales included for int8) at ``dtype`` storage (default: the
    model's compute dtype)."""
    n_layers, n_kv, head_dim = _model_kv_dims(model)
    dt = model.dtype if dtype is None else dtype
    if dt == torch.int8:
        per_head = head_dim + 4              # int8 row + one fp32 scale
    else:
        per_head = head_dim * dt.itemsize
    return 2 * n_layers * n_kv * per_head


def pages_for_budget(model, page_size: int, budget_bytes: int,
                     dtype=None) -> int:
    """How many KV pages fit a byte budget at ``dtype`` storage."""
    per_page = kv_bytes_per_token(model, dtype) * int(page_size)
    return int(budget_bytes) // per_page if per_page else 0


def make_pool(model, n_pages: int, page_size: int, device=None,
              dtype=None):
    """Zeroed ``(pool_k, pool_v)``, each ``[n_layers, n_pages, page_size,
    n_kv_heads, head_dim]`` on ``device`` (default: the model's), in the
    model's compute dtype, or :class:`QuantPool` halves when ``dtype`` is
    ``torch.int8`` (their views dequantize to the compute dtype)."""
    n_layers, n_kv, head_dim = _model_kv_dims(model)
    dev = model.device if device is None else device
    shape = (n_layers, n_pages, page_size, n_kv, head_dim)
    if dtype == torch.int8:
        def half():
            return QuantPool(torch.zeros(shape, dtype=torch.int8, device=dev),
                             torch.ones(shape[:-1], device=dev), model.dtype)
        return half(), half()
    dt = model.dtype if dtype is None else dtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def _quant_rows(x):
    """Symmetric int8 quantization of each row over the trailing
    head_dim axis: ``(q int8, scale fp32[...])``, with the rounding and
    zero-amax rules of :mod:`apex_tpu_torch.quant.kernels`."""
    from ..quant.kernels import amax_to_scale, quantize
    scale = amax_to_scale(x.float().abs().amax(dim=-1))
    return quantize(x, scale[..., None]), scale


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
        if isinstance(pool, QuantPool):
            d = (pool.data[:, tables].float()
                 * pool.scale[:, tables][..., None]).to(pool.out_dtype)
        else:
            d = pool[:, tables]
        return d.reshape(n_layers, s, n_pages_b * page_size, n_kv, head_dim)

    kd, vd = dense(pool_k), dense(pool_v)
    return [(kd[i], vd[i]) for i in range(n_layers)]


def scatter_prefill(pool, pages, dense):
    """Write one sequence's prefilled cache into its pages, in place.

    ``pages``: ``[n_pages_b]`` page ids; ``dense``: ``[n_layers, bucket,
    n_kv, head_dim]`` (the batch-1 view the prefill forward produced).
    An int8 pool quantizes per (token, head).  Returns ``pool``."""
    n_layers, _, page_size, n_kv, head_dim = pool.shape
    pages = pages.to(device=pool.device, dtype=torch.long)
    if isinstance(pool, QuantPool):
        q, sc = _quant_rows(dense)
        pool.data[:, pages] = q.reshape(n_layers, pages.shape[0], page_size,
                                        n_kv, head_dim)
        pool.scale[:, pages] = sc.reshape(n_layers, pages.shape[0],
                                          page_size, n_kv)
        return pool
    paged = dense.reshape(n_layers, pages.shape[0], page_size, n_kv,
                          head_dim)
    pool[:, pages] = paged.to(pool.dtype)
    return pool


def scatter_token(pool, page_ids, offsets, tok):
    """Write one fresh token's k or v per batch slot, in place.

    ``page_ids``/``offsets``: ``[S]`` (page and in-page offset of each
    slot's current position — dead slots point at the trash page);
    ``tok``: ``[n_layers, S, n_kv, head_dim]``.  An int8 pool quantizes
    per (token, head).  Returns ``pool``."""
    page_ids = page_ids.to(device=pool.device, dtype=torch.long)
    offsets = offsets.to(device=pool.device, dtype=torch.long)
    if isinstance(pool, QuantPool):
        q, sc = _quant_rows(tok)
        pool.data[:, page_ids, offsets] = q
        pool.scale[:, page_ids, offsets] = sc
        return pool
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
