"""ctypes wrapper of the CUDA fused LSTM-cell kernel
(``csrc/lstm_cell.cu``)."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import check, count_launch, dtype_code, entry, ptr, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# the fp32 route's tile and pipeline (csrc/lstm_cell.cu, kGRows ...)
ROWS, UNITS, K_TILE, STAGES = 128, 32, 16, 4
SPLITS = (1, 2, 4, 8)      # cluster sizes along K (8: the portable limit)
SMS = 132                  # H100 SXM; one CTA an SM (shared memory, regs)


class LaunchPlan(NamedTuple):
    split: int                  # CTAs of a cluster, each a K range
    k_per_split: int            # K a CTA covers (a multiple of K_TILE)
    grid: Tuple[int, int, int]  # (unit tiles, row tiles, split)


def launch_plan(B: int, D: int, H: int) -> LaunchPlan:
    """The fp32 route's launch: tiles of ROWS x UNITS (all four gates),
    and K = D + H split across a cluster of ``split`` CTAs. The split
    takes the fewest waves of work per CTA, ceil(CTAs / SMS) / split,
    the smallest split on a tie, among those that leave each CTA at least
    STAGES K tiles (the pipeline's depth) and none without K. The C entry
    takes the split and derives the rest as here."""
    tiles = -(-H // UNITS) * -(-B // ROWS)
    k_tiles = -(-(D + H) // K_TILE)
    fits = [s for s in SPLITS if s == 1 or (
        -(-k_tiles // s) >= STAGES and -(-k_tiles // s) * (s - 1) < k_tiles)]
    split = min(fits, key=lambda s: (-(-tiles * s // SMS) / s, s))
    return LaunchPlan(split, -(-k_tiles // split) * K_TILE,
                      (-(-H // UNITS), -(-B // ROWS), split))


def refuse_autograd(tensors) -> None:
    """The fused cell is forward-only, as the TPU kernel is (``jax.grad``
    through it fails): refuse an operand that would need a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "lstm_cell: the fused kernel is forward-only and records no "
            "gradient; train through the unfused cell "
            "(models.rnn.lstm_cell with kernel=None), or run under "
            "torch.no_grad()")


def lstm_cell(w, b, x, c, h):
    """One LSTM step. w: (D+H, 4H); b: (4H,); x: (B, D); c, h: (B, H);
    every operand float32 or bfloat16 (one type for all), contiguous, on
    one CUDA device. Returns (c_new, h_new) of c's shape and type.
    Launches on the current stream (fp32 with ``launch_plan``'s split).
    Forward only: with grad mode on, an operand that requires grad is
    refused (``refuse_autograd``)."""
    tensors = (w, b, x, c, h)
    if any(t.device != x.device or t.device.type != "cuda"
           for t in tensors):
        raise ValueError("lstm_cell: every operand must be on one CUDA "
                         "device")
    refuse_autograd(tensors)
    code = dtype_code(x)
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"lstm_cell: operands must share one dtype; got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_cell: operands must be contiguous")
    if x.dim() != 2 or c.dim() != 2:
        raise ValueError(f"lstm_cell: x must be (B, D) and c (B, H); got "
                         f"{tuple(x.shape)}, {tuple(c.shape)}")
    B, D = x.shape
    H = c.shape[1]
    if B == 0 or H == 0 or h.shape != (B, H) or c.shape != (B, H) or \
            w.shape != (D + H, 4 * H) or b.shape != (4 * H,):
        raise ValueError(
            f"lstm_cell: shapes disagree: w {tuple(w.shape)}, b "
            f"{tuple(b.shape)}, x {tuple(x.shape)}, c {tuple(c.shape)}, "
            f"h {tuple(h.shape)}")
    c_new = torch.empty_like(c)
    h_new = torch.empty_like(h)
    split = launch_plan(B, D, H).split if code == 0 else 1
    fn = entry("lstm_cell", "lstm_cell_launch", _ARGTYPES)
    err = fn(ptr(w), ptr(b), ptr(x), ptr(c), ptr(h), ptr(c_new), ptr(h_new),
             B, D, H, code, split, stream_ptr())
    check(err, "lstm_cell")
    lstm_cell.launches += 1
    count_launch("lstm_cell")     # on the device, in a graph being captured
    return c_new, h_new


lstm_cell.launches = 0
