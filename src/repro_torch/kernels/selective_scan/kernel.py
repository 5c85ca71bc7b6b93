"""ctypes wrapper of the CUDA selective-scan kernel
(``csrc/selective_scan.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import check, entry, ptr, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
STATE_WIDTHS = (8, 16)      # N values the kernel is instantiated for


def selective_scan(dt, A, B_, C_, x, h0):
    """The mamba1 recurrence over Q steps (a whole prompt, or one chunk
    of it). dt, x: (B, Q, Di); A: (Di, N); B_, C_: (B, Q, N); h0:
    (B, Di, N); every operand fp32, contiguous, 16-byte aligned, on one
    CUDA device (the kernel reads dt, x, B_ and C_ by TMA and A and h0
    in 16-byte loads); Q >= 1 and Di a multiple of 4 (a TMA map's row
    stride is a multiple of 16 bytes). Returns (y (B, Q, Di), h_out
    (B, Di, N)), both fp32. Launches on the current stream."""
    tensors = (dt, A, B_, C_, x, h0)
    if any(t.device != x.device or t.device.type != "cuda"
           for t in tensors):
        raise ValueError("selective_scan: every operand must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("selective_scan: operands must be float32; got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan: operands must be contiguous")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: x must be (B, Q, Di) and A "
                         f"(Di, N); got {tuple(x.shape)}, {tuple(A.shape)}")
    B, Q, Di = x.shape
    N = A.shape[1]
    if N not in STATE_WIDTHS:
        raise ValueError(f"selective_scan: d_state N must be one of "
                         f"{STATE_WIDTHS}; got {N}")
    if dt.shape != x.shape or A.shape != (Di, N) or \
            B_.shape != (B, Q, N) or C_.shape != (B, Q, N) or \
            h0.shape != (B, Di, N):
        raise ValueError(
            f"selective_scan: shapes disagree: dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B_ {tuple(B_.shape)}, C_ "
            f"{tuple(C_.shape)}, x {tuple(x.shape)}, h0 {tuple(h0.shape)}")
    if Q < 1 or Di % 4:
        raise ValueError(f"selective_scan: needs Q >= 1 and Di % 4 == 0 "
                         f"(the TMA maps' row stride, 4 * Di bytes, must "
                         f"be a multiple of 16); got Q {Q}, Di {Di}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("selective_scan: every operand must be 16-byte "
                         "aligned (the kernel reads them by TMA or in "
                         "16-byte loads)")
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    fn = entry("selective_scan", "selective_scan_launch", _ARGTYPES)
    code = fn(ptr(dt), ptr(A), ptr(B_), ptr(C_), ptr(x), ptr(h0), ptr(y),
              ptr(h_out), B, Q, Di, N, stream_ptr())
    check(code, "selective_scan")
    selective_scan.launches += 1
    return y, h_out


selective_scan.launches = 0
