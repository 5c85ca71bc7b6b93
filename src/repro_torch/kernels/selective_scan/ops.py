"""Dispatch for the selective-scan kernel: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor."""

from __future__ import annotations

from .. import on_cuda
from .kernel import selective_scan as _kernel
from .ref import selective_scan_ref


def selective_scan(dt, A, B_, C_, x, h0):
    if on_cuda(x):
        return _kernel(dt, A, B_, C_, x, h0)
    return selective_scan_ref(dt, A, B_, C_, x, h0)


__all__ = ["selective_scan", "selective_scan_ref"]
