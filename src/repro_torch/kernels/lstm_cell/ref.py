"""Plain PyTorch version of the fused LSTM-cell kernel: the JAX
package's ``kernels/lstm_cell/ref.py`` (concatenate, one fp32 matmul,
the gates in fp32)."""

from __future__ import annotations

import torch


def lstm_cell_ref(w, b, x, c, h):
    """w: (D+H, 4H); b: (4H,); x: (B, D); c/h: (B, H).

    Gate order [i, f, g, o]; forget-gate bias +1 (as
    ``models.rnn.lstm_cell``). Returns (c_new, h_new) in c's and h's
    dtypes, computed in fp32."""
    z = (torch.cat([x, h], dim=-1).float() @ w.float() + b.float())
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = (torch.sigmoid(f + 1.0) * c.float()
             + torch.sigmoid(i) * torch.tanh(g))
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return c_new.to(c.dtype), h_new.to(h.dtype)
