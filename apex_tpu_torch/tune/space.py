"""The card's legality rules for kernel tiles, and the shape buckets.

Counterpart of ``apex_tpu/tune/space.py``.  The TPU's model (a scoped-
VMEM budget, 8-row sublanes, 128-lane tiles) does not carry over; on the
H100 a tile is legal when

* a CUDA block's dynamic shared memory fits the card's opt-in limit
  (:func:`smem_per_block`: ``shared_memory_per_block_optin`` of the
  device, or the H100's 232448 bytes, its data-sheet value, off the
  card).  The CUDA kernels answer this for their own tiles: the tuner
  asks their libraries (``quant_matmul_tile``,
  ``flash_attention_fwd_check``) rather than restating their layouts;
* a Triton program's block holds powers of two, at most
  :data:`TRITON_MAX_NUMEL` elements, and its register tile at most
  :data:`TILE_BUDGET_BYTES` of fp32 working values (beyond that it
  spills).

:func:`pick_rows` and :func:`row_block_candidates` are the row rules of
the row-blocked Triton kernels (the BN epilogue's row block, the
LayerNorm's rows a program): a tuned value is rounded to a legal block
first, so a hand-edited cache entry can never reach a launch as an
illegal shape, and candidates that clamp onto the same block are kept
once (JAX's dedupe).  :func:`pow2_bucket` and :func:`nhwc_bucket` are
the JAX package's, unchanged: the cache keys of the two packages agree.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["SMEM_OPTIN_H100", "TRITON_MAX_NUMEL", "TILE_BUDGET_BYTES",
           "NUM_WARPS", "smem_per_block", "pow2_floor", "pick_rows",
           "tile_fits", "row_block_candidates", "pow2_bucket",
           "nhwc_bucket"]

#: dynamic shared memory a block may opt in to on an H100 (sm_90), the
#: data sheet's 227 KB; the limit off the card
SMEM_OPTIN_H100 = 232448
#: the most elements one Triton block (a ``tl.arange`` tile) may hold
TRITON_MAX_NUMEL = 1 << 20
#: working bytes of one Triton program's register tile: the 64K 32-bit
#: registers a block may hold on sm_90 (beyond it the tile spills)
TILE_BUDGET_BYTES = 256 * 1024
#: the warp counts a Triton launch takes
NUM_WARPS = (1, 2, 4, 8, 16, 32)


def smem_per_block(device: Optional[torch.device] = None) -> int:
    """Dynamic shared memory a block may opt in to on ``device`` (the
    current CUDA device by default); :data:`SMEM_OPTIN_H100` without a
    card."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return SMEM_OPTIN_H100
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None
        else torch.device(device))
    return int(getattr(props, "shared_memory_per_block_optin",
                       SMEM_OPTIN_H100))


def pow2_floor(n: int) -> int:
    """The largest power of two at most ``n`` (1 for ``n < 2``)."""
    n = max(1, int(n))
    return 1 << (n.bit_length() - 1)


def pick_rows(n_rows: int, width: int, bytes_per_elem: int, *,
              row_block: int, budget: int = TILE_BUDGET_BYTES) -> int:
    """Rows of a ``[rows, width]`` Triton tile for a row block of
    ``row_block``: rounded down to a power of two (so any cached value,
    a hand-edited 100 or a hostile 3, is a legal block), then halved
    until ``rows * width * bytes_per_elem`` fits ``budget`` and the tile
    holds at most :data:`TRITON_MAX_NUMEL` elements, at least 1, and no
    more than the power of two that covers ``n_rows``."""
    rows = pow2_floor(row_block)
    while rows > 1 and (rows * width * bytes_per_elem > budget
                        or rows * width > TRITON_MAX_NUMEL):
        rows //= 2
    cover = 1 << max(0, int(n_rows) - 1).bit_length()
    return max(1, min(rows, cover))


def tile_fits(rows: int, width: int, bytes_per_elem: int, *,
              budget: int = TILE_BUDGET_BYTES) -> bool:
    """Whether a ``[rows, width]`` tile is a legal Triton block within
    the register budget (``rows`` and ``width`` powers of two)."""
    pow2 = rows > 0 and width > 0 and not rows & (rows - 1) \
        and not width & (width - 1)
    return bool(pow2 and rows * width <= TRITON_MAX_NUMEL
                and rows * width * bytes_per_elem <= budget)


def row_block_candidates(n_rows: int, width: int, bytes_per_elem: int, *,
                         budget: int = TILE_BUDGET_BYTES,
                         blocks=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                         ) -> List[int]:
    """Legal ``row_block`` candidates for a ``[n_rows, width]`` kernel:
    the ``blocks`` whose clamped tile (:func:`pick_rows`) is one no
    smaller candidate already gives, so the tuner never times one
    effective block twice."""
    seen = set()
    out: List[int] = []
    for blk in blocks:
        eff = pick_rows(n_rows, width, bytes_per_elem, row_block=blk,
                        budget=budget)
        if eff in seen:
            continue
        seen.add(eff)
        out.append(blk)
    return out


def pow2_bucket(n: int) -> int:
    """Round ``n`` up to the next power of two — the shape-bucket
    granularity of the config cache keys (two batch sizes in the same
    pow2 bucket share a tuned config)."""
    n = max(1, int(n))
    b = 1
    while b < n:
        b <<= 1
    return b


def nhwc_bucket(n: int, h: int, w: int, c: int) -> str:
    """Shape bucket for a 4-D NHWC conv operand: batch and the joint
    spatial extent ``h*w`` round to powers of two (a conv blocks over
    flattened output rows, so ``56x56`` and ``64x49`` share a winner);
    channels stay exact."""
    return f"n{pow2_bucket(n)}_s{pow2_bucket(h * w)}_c{int(c)}"
