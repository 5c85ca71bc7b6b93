"""Dispatch for the fused LSTM-cell kernel: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor. Both refuse autograd, so
the fused cell is forward-only on every device, as in the JAX
package."""

from __future__ import annotations

from .. import on_cuda
from .kernel import lstm_cell as _kernel
from .kernel import refuse_autograd
from .ref import lstm_cell_ref


def lstm_cell(w, b, x, c, h):
    if on_cuda(x):
        return _kernel(w, b, x, c, h)
    refuse_autograd((w, b, x, c, h))
    return lstm_cell_ref(w, b, x, c, h)


__all__ = ["lstm_cell", "lstm_cell_ref"]
