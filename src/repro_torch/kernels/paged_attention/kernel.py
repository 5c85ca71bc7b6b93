"""ctypes wrapper of the CUDA paged-attention decode kernel
(``csrc/paged_attention.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import (check, dtype_code, library, ptr, stream_ptr,
                validate_block_table_call)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def paged_attention(q, k_pool, v_pool, table, cur_len):
    """q: (B, 1, H, hd); k/v_pool: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; cur_len: (B,) int32 -> (B, 1, H, hd). CUDA tensors
    only; launches on the current stream."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_attention: q must be (B, 1, H, hd); got "
                         f"{tuple(q.shape)}")
    block, KV, bpr = validate_block_table_call(
        q, k_pool, v_pool, table, cur_len, "paged_attention")
    B, _, H, hd = q.shape
    out = torch.empty_like(q)
    fn = library("paged_attention").paged_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    code = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(cur_len),
              ptr(out), B, H, KV, hd, block, bpr, dtype_code(q),
              stream_ptr())
    check(code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
