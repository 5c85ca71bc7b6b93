"""Dispatch for the paged-attention decode kernel: the CUDA kernel for
a CUDA tensor, the plain version for a CPU tensor."""

from __future__ import annotations

from .. import on_cuda
from .kernel import paged_attention as _kernel
from .ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, table, cur_len, q_head0=0,
                    n_heads=None):
    if on_cuda(q):
        return _kernel(q, k_pool, v_pool, table, cur_len, q_head0, n_heads)
    return paged_attention_ref(q, k_pool, v_pool, table, cur_len, q_head0,
                               n_heads)


__all__ = ["paged_attention", "paged_attention_ref"]
