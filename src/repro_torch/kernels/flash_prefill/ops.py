"""Dispatch for the flash-prefill chunk kernel and its verify entry: the
CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""

from __future__ import annotations

from .. import on_cuda
from .kernel import flash_prefill as _kernel
from .kernel import flash_verify as _verify_kernel
from .ref import flash_prefill_ref


def flash_prefill(q, k_pool, v_pool, table, q_off, q_head0=0,
                  n_heads=None):
    if on_cuda(q):
        return _kernel(q, k_pool, v_pool, table, q_off, q_head0, n_heads)
    return flash_prefill_ref(q, k_pool, v_pool, table, q_off, q_head0,
                             n_heads)


def flash_verify(q, k_pool, v_pool, table, q_off, q_head0=0, n_heads=None):
    """A speculative window ``q (B, W, H, hd)`` at ``q_off = cur_len - 1``;
    the chunk kernel's semantics, so its plain version is
    ``flash_prefill_ref``."""
    if on_cuda(q):
        return _verify_kernel(q, k_pool, v_pool, table, q_off, q_head0,
                              n_heads)
    return flash_prefill_ref(q, k_pool, v_pool, table, q_off, q_head0,
                             n_heads)


__all__ = ["flash_prefill", "flash_verify", "flash_prefill_ref"]
