"""Plain PyTorch version of the flash-attention kernel: the JAX
package's ``kernels/flash_attention/ref.py``, all math in fp32."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, S, H, D); k/v: (B, T, KV, D) -> (B, S, H, D) in q's dtype.

    Causal masking is top-left aligned (key t is visible to query s when
    t <= s), also when T != S."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)
