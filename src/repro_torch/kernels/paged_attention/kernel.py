"""ctypes wrapper of the CUDA paged-attention decode kernel
(``csrc/paged_attention.cu``): a split-K pass over position partitions,
then a combine pass, both from one C entry."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import (check, count_launch, dtype_code, entry, ptr, stream_ptr,
                validate_block_table_call)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]

SPLIT = 64          # positions per partition (kSplit in the source)
ROW_TILES = (1, 2, 4, 8)   # query rows a CTA may hold


class SplitPlan(NamedTuple):
    """How one decode call is launched: the C entry checks these values
    and launches with them."""
    split: int                          # positions per partition
    n_splits: int                       # partitions per row
    rows: int                           # query rows per CTA (>= its real rows)
    row_tiles: int                      # CTAs that share one group's G rows
    grid: Tuple[int, int, int]          # of the partition pass
    scratch: Tuple[int, ...]            # fp32 partials: acc then (m, l)


def split_plan(B: int, KV: int, G: int, bpr: int, block: int,
               hd: int, heads: Optional[int] = None,
               q_head0: int = 0) -> SplitPlan:
    """The launch plan, from shapes the host knows (never from
    ``cur_len``, which lives on the device): each row's ``bpr * block``
    positions in partitions of ``SPLIT`` (partition s holds positions
    ``[s * SPLIT, (s + 1) * SPLIT)``, the last one cut at the table's
    width); a CTA per (row, KV head, partition, tile of ``rows`` of the
    G query rows), ``rows`` the smallest of ``ROW_TILES`` that covers
    G, or 8. The scratch holds one fp32 partial (``hd`` accumulator
    values, then m and l) per (row, query head, partition).

    A head range (``heads`` query heads from ``q_head0``, of the G * KV
    whose groups are G): the grid's second dim walks the K/V heads the
    range touches, and each tile covers up to ``min(G, heads)`` of a K/V
    head's query heads in the range (a tile past a K/V head's last one
    exits); the whole range (the default) is the plan above."""
    heads = KV * G if heads is None else heads
    n_kv = (q_head0 + heads - 1) // G - q_head0 // G + 1
    cover = min(G, heads)
    n_splits = -(-bpr * block // SPLIT)
    rows = next(r for r in ROW_TILES if r >= min(cover, ROW_TILES[-1]))
    row_tiles = -(-cover // rows)
    return SplitPlan(SPLIT, n_splits, rows, row_tiles,
                     (B, n_kv, n_splits * row_tiles),
                     (B * heads * n_splits * (hd + 2),))


def paged_attention(q, k_pool, v_pool, table, cur_len, q_head0=0,
                    n_heads=None):
    """q: (B, 1, H, hd); k/v_pool: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; cur_len: (B,) int32 -> (B, 1, H, hd). CUDA tensors
    only; launches on the current stream (two kernels, counted as one
    launch). A head range: q holds heads ``[q_head0, q_head0 + H)`` of
    ``n_heads`` (default H), local head j reading K/V head ``(q_head0 +
    j) // (n_heads // KV)``."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_attention: q must be (B, 1, H, hd); got "
                         f"{tuple(q.shape)}")
    block, KV, bpr, n_heads = validate_block_table_call(
        q, k_pool, v_pool, table, cur_len, "paged_attention",
        q_head0=q_head0, n_heads=n_heads)
    B, _, H, hd = q.shape
    plan = split_plan(B, KV, n_heads // KV, bpr, block, hd, H, q_head0)
    out = torch.empty_like(q)
    part = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
    fn = entry("paged_attention", "paged_attention_launch", _ARGTYPES)
    code = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(cur_len),
              ptr(out), ptr(part), B, H, KV, hd, block, bpr, plan.split,
              plan.n_splits, plan.rows, plan.row_tiles, n_heads,
              int(q_head0), dtype_code(q), stream_ptr())
    check(code, "paged_attention")
    paged_attention.launches += 1
    count_launch("paged_attention")
    return out


paged_attention.launches = 0
