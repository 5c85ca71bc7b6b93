"""ctypes wrapper of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import check, dtype_code, entry, ptr, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
HEAD_DIMS = (8, 16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)


def route(D: int, dtype: torch.dtype) -> str:
    """The body of ``csrc/flash_attention.cu`` that a call takes: bf16 at
    D in WGMMA_HEAD_DIMS runs wgmma on TMA-loaded tiles, bf16 at the
    smoke widths mma.sync, fp32 the fp32 pipes."""
    if dtype == torch.bfloat16:
        return "wgmma" if D in WGMMA_HEAD_DIMS else "mma.sync"
    return "fp32"


def refuse_autograd(tensors) -> None:
    """The kernel is forward-only, as the TPU kernel is (``jax.grad``
    through it fails): refuse an operand that would need a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention: the kernel is forward-only and records no "
            "gradient; train with attn_impl=\"gather\" (chunked_attention "
            "through autograd), or run the forward under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True):
    """Full-sequence GQA attention. q: (B, S, H, D); k, v: (B, T, KV, D)
    with H % KV == 0 and D in HEAD_DIMS; every operand float32
    or bfloat16 (one type for all), contiguous, 16-byte aligned, on one
    CUDA device (``route`` says which kernel body runs).
    Returns (B, S, H, D) in q's type; the math is fp32. Causal masking
    is top-left aligned. Launches on the current stream. Forward only:
    with grad mode on, an operand that requires grad is refused
    (``refuse_autograd``)."""
    tensors = (q, k, v)
    if any(t.device != q.device or t.device.type != "cuda"
           for t in tensors):
        raise ValueError("flash_attention: every operand must be on one "
                         "CUDA device")
    refuse_autograd(tensors)
    code = dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: operands must share one dtype; "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention: operands must be 16-byte aligned "
                         "(TMA boxes and 16-byte loads)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, S, H, D) and k, v "
                         f"(B, T, KV, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    _, T, KV, kd = k.shape
    if k.shape[0] != B or kd != D or D not in HEAD_DIMS or KV == 0 or \
            H % KV or T == 0:
        raise ValueError(f"flash_attention: needs matching B and D, D in "
                         f"{HEAD_DIMS}, H % KV == 0 and T > 0; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    fn = entry("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(ptr(q), ptr(k), ptr(v), ptr(out), B, S, T, H, KV, D,
             int(causal), code, stream_ptr())
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
