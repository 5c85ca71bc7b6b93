"""Dispatch for the flash-prefill chunk kernel: the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor."""

from __future__ import annotations

from .. import on_cuda
from .kernel import flash_prefill as _kernel
from .ref import flash_prefill_ref


def flash_prefill(q, k_pool, v_pool, table, q_off):
    if on_cuda(q):
        return _kernel(q, k_pool, v_pool, table, q_off)
    return flash_prefill_ref(q, k_pool, v_pool, table, q_off)


__all__ = ["flash_prefill", "flash_prefill_ref"]
