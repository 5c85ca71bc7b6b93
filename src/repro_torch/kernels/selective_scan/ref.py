"""Plain PyTorch version of the selective-scan (mamba1 recurrence)
kernel: the sequential recurrence of the JAX package's
``kernels/selective_scan/ref.py``, in fp32."""

from __future__ import annotations

import torch


def selective_scan_ref(dt, A, B_, C_, x, h0):
    """Sequential reference recurrence over one chunk.

    dt: (B, Q, Di)   softplus'd step sizes
    A:  (Di, N)      negative state matrix (diagonal)
    B_: (B, Q, N)    input projections
    C_: (B, Q, N)    output projections
    x:  (B, Q, Di)   conv'd activations
    h0: (B, Di, N)   incoming state
    Returns (y (B, Q, Di) in x's dtype, h_out (B, Di, N) fp32), computed
    in fp32."""
    dt, A, B_, C_ = dt.float(), A.float(), B_.float(), C_.float()
    xf, h = x.float(), h0.float()
    ys = []
    for t in range(xf.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)                # (B, Di, N)
        dBx = (dt[:, t] * xf[:, t])[..., None] * B_[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
