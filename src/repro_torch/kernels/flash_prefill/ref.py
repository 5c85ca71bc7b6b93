"""Plain PyTorch version of the flash-prefill chunk kernel.

Semantics: a C-token query chunk whose first token sits at stream
position ``q_off[b]`` attends causally over the row's cache: query
``i`` sees exactly lanes ``[0, q_off[b] + i]``, the chunk's own K/V
included (callers write the chunk into the pool first). K/V are
gathered through the block table the way the decode version does
(``-1`` entries clip to block 0 and are masked), then one fp32 masked
softmax runs per query row, with q scaled in fp32 as the kernel does.
"""

from __future__ import annotations

import math

import torch

from ..paged_attention.ref import NEG_INF, gather_kv


def flash_prefill_ref(q, k_pool, v_pool, table, q_off):
    """q: (B, C, H, hd); pools: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; q_off: (B,) int32 -> (B, C, H, hd) in q's dtype."""
    B, C, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    kg, vg = gather_kv(k_pool, v_pool, table)
    T = kg.shape[1]
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, C, KV, G, hd)
    s = torch.einsum("bckgd,btkd->bkgct", qf, kg.float())
    qpos = q_off.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = torch.arange(T, device=q.device)[None, None, :] \
        <= qpos[:, :, None]                                    # (B, C, T)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgct,btkd->bkgcd", p, vg.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)
