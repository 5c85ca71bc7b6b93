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

A head range (``q_head0``, ``n_heads``): q holds the query heads
``[q_head0, q_head0 + H)`` of ``n_heads`` against every K/V head of the
pools, and local head j reads K/V head ``(q_head0 + j) // (n_heads //
KV)``; the whole range is the plain call, with the same arithmetic.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def range_kv(kg, vg, H, q_head0=0, n_heads=None):
    """Gathered K/V ``(B, T, KV, hd)`` laid out per local query head of a
    head range (one K/V head each, so G = 1); the whole range as it is."""
    if n_heads is None or (q_head0 == 0 and n_heads == H):
        return kg, vg
    KV = kg.shape[2]
    if n_heads % KV or not 0 <= q_head0 <= n_heads - H:
        raise ValueError(f"head range [{q_head0}, {q_head0 + H}) of "
                         f"{n_heads} heads over {KV} K/V heads")
    idx = (q_head0 + torch.arange(H, device=kg.device)) // (n_heads // KV)
    return kg.index_select(2, idx), vg.index_select(2, idx)


def gather_kv(k_pool, v_pool, table):
    """Dense ``(B, bpr * block, KV, hd)`` K/V through the block table;
    ``table`` entries < 0 clip to physical block 0."""
    _, block, KV, hd = k_pool.shape
    B, bpr = table.shape
    safe = table.clamp(min=0).long()
    kg = k_pool[safe].reshape(B, bpr * block, KV, hd)
    vg = v_pool[safe].reshape(B, bpr * block, KV, hd)
    return kg, vg


def paged_attention_ref(q, k_pool, v_pool, table, cur_len, q_head0=0,
                        n_heads=None):
    """q: (B, 1, H, hd); pools: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; cur_len: (B,) int32 -> (B, 1, H, hd) in q's dtype.
    ``q_head0``/``n_heads``: a head range (module docstring)."""
    B, _, H, hd = q.shape
    kg, vg = range_kv(*gather_kv(k_pool, v_pool, table), H, q_head0,
                      n_heads)
    KV = kg.shape[2]
    G = H // KV
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
