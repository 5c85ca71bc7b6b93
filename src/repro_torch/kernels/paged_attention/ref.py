"""Plain PyTorch version of the paged-attention decode kernel.

It computes exactly what the CUDA kernel computes: K/V are gathered
through the block table into the dense ``(B, bpr * block, KV, hd)``
layout (unallocated ``-1`` entries clip to block 0; those lanes are
masked by ``cur_len``), then one fp32 masked softmax per query head,
with q scaled in fp32. A row with ``cur_len == 0`` sees nothing and
returns 0, as the kernel (and the JAX package's Pallas kernel) does; the
JAX package's ``paged_attention_ref`` returns the mean of the masked
lanes there instead, so parity with that oracle holds for
``cur_len >= 1``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_kv(k_pool, v_pool, table):
    """Dense ``(B, bpr * block, KV, hd)`` K/V through the block table;
    ``table`` entries < 0 clip to physical block 0."""
    _, block, KV, hd = k_pool.shape
    B, bpr = table.shape
    safe = table.clamp(min=0).long()
    kg = k_pool[safe].reshape(B, bpr * block, KV, hd)
    vg = v_pool[safe].reshape(B, bpr * block, KV, hd)
    return kg, vg


def paged_attention_ref(q, k_pool, v_pool, table, cur_len):
    """q: (B, 1, H, hd); pools: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; cur_len: (B,) int32 -> (B, 1, H, hd) in q's dtype."""
    B, _, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    kg, vg = gather_kv(k_pool, v_pool, table)
    T = kg.shape[1]
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qf, kg.float())
    cur = cur_len.long()
    mask = torch.arange(T, device=q.device)[None, :] < cur[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, vg.float())
    o = torch.where((cur > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, 1, H, hd).to(q.dtype)
