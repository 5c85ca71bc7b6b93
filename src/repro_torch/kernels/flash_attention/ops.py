"""Dispatch for the flash-attention kernel: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor. Both refuse autograd, so
the kernel path is forward-only on every device, as in the JAX
package."""

from __future__ import annotations

from .. import on_cuda
from .kernel import flash_attention as _kernel
from .kernel import refuse_autograd
from .ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True):
    if on_cuda(q):
        return _kernel(q, k, v, causal=causal)
    refuse_autograd((q, k, v))
    return attention_ref(q, k, v, causal=causal)


__all__ = ["flash_attention", "attention_ref"]
