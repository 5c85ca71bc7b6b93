"""Attention math: chunked online softmax, and attention against a KV
cache view for chunked prefill, speculative verify windows and
single-token decode.

Port of ``repro/models/attention.py`` (``chunked_attention``,
``prefill_attention``, ``verify_attention``, ``decode_attention``). Same
arithmetic, op for op: scores in fp32 from compute-dtype operands, the
online softmax over the same ``k_chunk`` blocks, ``p`` cast to the V
dtype before PV in the blockwise paths and kept fp32 through PV in
decode and verify.

``attn_impl="cuda"`` routes a PAGED view to the block-table kernels
(``kernels.flash_prefill`` and its ``flash_verify`` entry,
``kernels.paged_attention``): K/V are read
through the block table and the dense ``(rows, max_len, KV, hd)``
layout is never built. Dense views, and ``attn_impl="gather"``, gather
(the JAX package's ``"xla"`` path).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_to(x, mult: int, dim: int):
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), n


def _online_block(acc, m, l, s, vs, eq_pv: str):
    """One online-softmax update: fp32 scores ``s`` (already masked),
    ``p`` cast to the V dtype for the PV product, fp32 accumulation."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum(eq_pv, p.to(vs.dtype).float(), vs.float())
    return acc * corr[..., None] + pv, m_new, l_new


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      k_chunk: int = 1024, q_offset: int = 0,
                      kv_valid_len: Optional[int] = None,
                      skip_masked_blocks: bool = False):
    """q: (B,S,H,D); k/v: (B,T,KV,D); returns (B,S,H,D).

    q_offset: absolute position of q[0]; kv_valid_len: mask out key
    positions at or past it. ``skip_masked_blocks`` stops each q-chunk's
    key loop at the causal diagonal (blocks past it are exact no-ops of
    the accumulator, so the result is the same)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    q_chunk, k_chunk = min(q_chunk, S), min(k_chunk, T)
    qg, S_valid = _pad_to((q * scale).reshape(B, S, KV, G, D), q_chunk, 1)
    k, T_valid = _pad_to(k, k_chunk, 1)
    v, _ = _pad_to(v, k_chunk, 1)
    nq, nk = qg.shape[1] // q_chunk, k.shape[1] // k_chunk
    kv_limit = T_valid if kv_valid_len is None else kv_valid_len
    dev = q.device
    blocks = []
    for i in range(nq):
        qc = qg[:, i * q_chunk:(i + 1) * q_chunk].float()
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, D), device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        hi = nk
        if skip_masked_blocks and causal and nq > 1:
            hi = max(min(nk, math.ceil(((i + 1) * q_chunk + q_offset)
                                       / k_chunk)), 1)
        for j in range(hi):
            ks = k[:, j * k_chunk:(j + 1) * k_chunk]
            vs = v[:, j * k_chunk:(j + 1) * k_chunk]
            kpos = j * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, ks.float())
            mask = (kpos[None, :] < kv_limit).expand(q_chunk, k_chunk)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask, s, NEG_INF)
            acc, m, l = _online_block(acc, m, l, s, vs,
                                      "bkgqt,btkd->bkgqd")
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.permute(0, 3, 1, 2, 4))     # (B, Qc, KV, G, D)
    out = torch.cat(blocks, dim=1)[:, :S_valid]
    return out.reshape(B, S_valid, H, D).to(q.dtype)


def prefill_attention(q, kv, *, q_off, attn_impl: str = "gather",
                      k_chunk: int = 1024):
    """Chunked-prefill attention: a C-token chunk against a cache view
    whose lanes already hold the row's prior K/V and this chunk's own
    (callers ``write_chunk`` first). q: (B, C, H, D); q_off: (B,) int32,
    the absolute position of ``q[:, 0]`` per row. Query ``i`` of row
    ``b`` attends lanes ``[0, q_off[b] + i]``.

    The gather path runs the same blockwise online softmax as
    ``chunked_attention`` (same ``k_chunk`` boundaries, same op order),
    so each real query's output equals one-shot prefill's."""
    if attn_impl == "cuda":
        state = kv.paged_state()
        if state is not None:
            from ..kernels.flash_prefill.ops import flash_prefill
            k_pool, v_pool, table = state
            return flash_prefill(q, k_pool, v_pool, table, q_off)
    k_cache, v_cache = kv.gather()
    B, C, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    dev = q.device
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, C, KV, G, D).float()
    qpos = q_off.long()[:, None] + torch.arange(C, device=dev)[None, :]
    kc = min(k_chunk, T)
    k_cache, _ = _pad_to(k_cache, kc, 1)
    v_cache, _ = _pad_to(v_cache, kc, 1)
    acc = torch.zeros((B, KV, G, C, D), device=dev)
    m = torch.full((B, KV, G, C), NEG_INF, device=dev)
    l = torch.zeros((B, KV, G, C), device=dev)
    for j in range(k_cache.shape[1] // kc):
        ks = k_cache[:, j * kc:(j + 1) * kc]
        vs = v_cache[:, j * kc:(j + 1) * kc]
        kpos = j * kc + torch.arange(kc, device=dev)
        s = torch.einsum("bckgd,btkd->bkgct", qg, ks.float())
        mask = kpos[None, None, :] <= qpos[:, :, None]          # (B, C, kc)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        acc, m, l = _online_block(acc, m, l, s, vs, "bkgct,btkd->bkgcd")
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, D).to(q.dtype)


def verify_attention(q, kv, *, q_off, attn_impl: str = "gather"):
    """A speculative verify window against a cache view whose lanes
    already hold the window's own K/V (callers ``write_chunk`` at
    ``q_off`` first). q: (B, W, H, D); q_off: (B,) int32, the position of
    ``q[:, 0]`` (``cur_len - 1``). Query ``j`` sees lanes
    ``[0, q_off + j]``, what a decode step at ``cur_len = q_off + j + 1``
    sees.

    The gather path is ``decode_attention``'s full-width masked softmax,
    vectorised over the window (not ``prefill_attention``'s online
    softmax), because each window position stands in for a decode step:
    stale lanes past ``q_off + j`` (rejected drafts) are masked before
    the softmax, and ``p`` stays fp32 through PV. ``attn_impl="cuda"``
    with a paged view launches the chunk kernel's ``flash_verify``
    entry."""
    if attn_impl == "cuda":
        state = kv.paged_state()
        if state is not None:
            from ..kernels.flash_prefill.ops import flash_verify
            k_pool, v_pool, table = state
            return flash_verify(q, k_pool, v_pool, table, q_off)
    k_cache, v_cache = kv.gather()
    B, W, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, W, KV, G, D)
    s = torch.einsum("bwkgd,btkd->bwkgt", qg.float(), k_cache.float())
    qpos = q_off.long()[:, None] + torch.arange(W, device=q.device)[None]
    mask = torch.arange(T, device=q.device)[None, None, None, None, :] \
        <= qpos[:, :, None, None, None]
    p = F.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bwkgt,btkd->bwkgd", p, v_cache.float())
    return out.reshape(B, W, H, D).to(q.dtype)


def decode_attention(q, kv, *, cur_len, attn_impl: str = "gather"):
    """Single-position attention against a cache view. q: (B, 1, H, D);
    cur_len: valid cache positions (the current token included), an int
    or a (B,) int32 tensor of per-row depths.

    ``attn_impl="cuda"`` with a paged view launches the paged-attention
    kernel; anything else gathers. The gather path keeps ``p`` in fp32
    through the PV product, as the JAX package does."""
    B, _, H, D = q.shape
    if attn_impl == "cuda":
        state = kv.paged_state()
        if state is not None:
            from ..kernels.paged_attention.ops import paged_attention
            k_pool, v_pool, table = state
            cur = (cur_len if torch.is_tensor(cur_len) else
                   torch.full((B,), cur_len, dtype=torch.int32,
                              device=q.device))
            return paged_attention(q, k_pool, v_pool, table, cur)
    k_cache, v_cache = kv.gather()
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float())
    cur = cur_len
    if torch.is_tensor(cur) and cur.dim() == 1:
        cur = cur[:, None, None, None]
    mask = torch.arange(T, device=q.device)[None, None, None, :] < cur
    p = F.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
