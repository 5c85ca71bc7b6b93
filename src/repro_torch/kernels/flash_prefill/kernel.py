"""ctypes wrapper of the CUDA flash-prefill chunk kernel
(``csrc/flash_prefill.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import (check, count_launch, dtype_code, entry, ptr, stream_ptr,
                validate_block_table_call)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def flash_prefill(q, k_pool, v_pool, table, q_off):
    """q: (B, C, H, hd); k/v_pool: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; q_off: (B,) int32 -> (B, C, H, hd). CUDA tensors
    only; launches on the current stream."""
    if q.dim() != 4:
        raise ValueError(f"flash_prefill: q must be (B, C, H, hd); got "
                         f"{tuple(q.shape)}")
    # the bf16 route copies K/V with 16-byte cp.async; the fp32 route
    # reads one element at a time
    block, KV, bpr = validate_block_table_call(
        q, k_pool, v_pool, table, q_off, "flash_prefill",
        align=16 if q.dtype == torch.bfloat16 else 4)
    B, C, H, hd = q.shape
    out = torch.empty_like(q)
    fn = entry("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    code = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(q_off),
              ptr(out), B, C, H, KV, hd, block, bpr, dtype_code(q),
              stream_ptr())
    check(code, "flash_prefill")
    flash_prefill.launches += 1
    count_launch("flash_prefill")
    return out


flash_prefill.launches = 0
