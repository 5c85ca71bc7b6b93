"""ctypes wrapper of the CUDA flash-prefill chunk kernel
(``csrc/flash_prefill.cu``), and of its speculative-verify entry."""

from __future__ import annotations

import ctypes

import torch

from .. import (check, count_launch, dtype_code, entry, ptr, stream_ptr,
                validate_block_table_call)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _launch(q, k_pool, v_pool, table, q_off, what):
    """One launch of the chunk kernel for the entry ``what``."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, C, H, hd); got "
                         f"{tuple(q.shape)}")
    # the bf16 route copies K/V with 16-byte cp.async; the fp32 route
    # reads one element at a time
    block, KV, bpr = validate_block_table_call(
        q, k_pool, v_pool, table, q_off, what,
        align=16 if q.dtype == torch.bfloat16 else 4)
    B, C, H, hd = q.shape
    out = torch.empty_like(q)
    fn = entry("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    code = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(q_off),
              ptr(out), B, C, H, KV, hd, block, bpr, dtype_code(q),
              stream_ptr())
    check(code, what)
    return out


def flash_prefill(q, k_pool, v_pool, table, q_off):
    """q: (B, C, H, hd); k/v_pool: (n_blocks, block, KV, hd); table:
    (B, bpr) int32; q_off: (B,) int32 -> (B, C, H, hd). CUDA tensors
    only; launches on the current stream."""
    out = _launch(q, k_pool, v_pool, table, q_off, "flash_prefill")
    flash_prefill.launches += 1
    count_launch("flash_prefill")
    return out


def flash_verify(q, k_pool, v_pool, table, q_off):
    """The speculative-verify entry (the JAX package's ``flash_verify``):
    q (B, W, H, hd) is a W = k+1 token window whose first query sits at
    ``q_off = cur_len - 1``; query j sees lanes ``[0, q_off + j]``, the
    chunk contract. The kernel takes any chunk width, so the window needs
    none of the TPU entry's sublane padding. Counted apart from the
    prefill chunks."""
    out = _launch(q, k_pool, v_pool, table, q_off, "flash_verify")
    flash_verify.launches += 1
    count_launch("flash_verify")
    return out


flash_prefill.launches = 0
flash_verify.launches = 0
