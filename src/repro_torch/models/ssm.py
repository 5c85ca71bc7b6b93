"""Mamba-1 mixer (the selective scan) for the pure-SSM family.

Port of the mamba1 half of ``repro/models/ssm.py`` (``mamba1_params``,
``_causal_conv``, ``_conv_step``, ``_ssm_inputs_m1``,
``mamba1_forward``, ``mamba1_init_state``, ``mamba1_step``); mamba2
waits for the hybrid slice. Same arithmetic: the projections and the
causal conv run in the compute dtype, the recurrence in fp32 with
``A_log``, ``dt_bias`` and ``D_skip`` kept in fp32 (``bridge`` leaves
these three in the param dtype).

``cfg.ssm.scan_impl`` picks the recurrence:

- ``"cuda"``: ``kernels.selective_scan`` (the hand-written kernel for a
  CUDA tensor, its plain sequential version for a CPU one), called once
  over the whole sequence: the recurrence is sequential per state, so
  the state crosses what were chunk boundaries in registers, and the
  result equals a chain of chunk calls bit for bit;
- ``"blocked"``: the JAX package's three-pass scheme over sub-blocks of
  8 steps, in plain PyTorch;
- ``"assoc"``: an inclusive scan of the affine maps
  ``h -> exp(dt*A)*h + dt*x*B`` by recursive doubling (Hillis-Steele),
  in plain PyTorch. It computes the same recurrence exactly, with the
  products associated in another order than the JAX package's
  ``lax.associative_scan``.

``"blocked"`` and ``"assoc"`` build (B, Q, d_inner, N) intermediates,
so each walks the sequence in chunks of ``cfg.ssm.chunk`` steps (one
chunk of the whole sequence when its length is not a multiple),
carrying the (B, d_inner, N) state from chunk to chunk in a Python loop
(``_chunked``), as the JAX package does for the same reason.

Decode (``mamba1_step``) is one state update per token.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan.ops import selective_scan

# leaves the JAX package reads in fp32 whatever the compute dtype
PARAM_DTYPE_LEAVES = ("A_log", "dt_bias", "D_skip")
SUB = 8          # sub-block length of the blocked scan


def mamba1_params(b, cfg):
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    dt_rank = max(1, math.ceil(d / 16))
    return {
        "in_proj": b.p((d, 2 * di)),
        "conv_w": b.p((s.d_conv, di), init="normal", scale=0.2),
        "conv_b": b.p((di,), init="zeros"),
        "x_proj": b.p((di, dt_rank + 2 * s.d_state)),
        "dt_proj": b.p((dt_rank, di)),
        "dt_bias": b.p((di,), init="zeros", param_dtype=True),
        "A_log": b.p((di, s.d_state), init="normal", scale=0.5,
                     param_dtype=True),
        "D_skip": b.p((di,), init="ones", param_dtype=True),
        "out_proj": b.p((di, d)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv via K shifted adds. x: (B, S, Di); w:
    (K, Di)."""
    K = w.shape[0]
    out = x * w[K - 1]
    for j in range(1, K):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[K - 1 - j]
    return out + b


def _conv_step(conv_state, x_t, w, b):
    """conv_state: (B, K-1, Di); x_t: (B, Di). Returns (new_state, y)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)     # (B, K, Di)
    y = torch.einsum("bkd,kd->bd", window, w) + b
    return window[:, 1:], y


def _ssm_inputs_m1(p, x, cfg):
    """Shared preamble: (dt, B, C) from the conv'd activations, fp32."""
    s = cfg.ssm
    dt_rank = p["dt_proj"].shape[0]
    dbc = x @ p["x_proj"].to(x.dtype)
    dt_low, B_, C_ = torch.split(dbc, [dt_rank, s.d_state, s.d_state],
                                 dim=-1)
    dt = F.softplus((dt_low @ p["dt_proj"].to(x.dtype)).float()
                    + p["dt_bias"].float())
    return dt, B_.float(), C_.float()


def _prefix_scan(a, b, dim: int):
    """Inclusive scan along ``dim`` of the affine maps ``h -> a*h + b``
    by recursive doubling: after the pass at distance k, entry t holds
    the composition of steps ``t-2k+1 .. t``."""
    n, k = a.shape[dim], 1
    while k < n:
        a_prev, b_prev = a.narrow(dim, 0, n - k), b.narrow(dim, 0, n - k)
        a_cur, b_cur = a.narrow(dim, k, n - k), b.narrow(dim, k, n - k)
        a = torch.cat([a.narrow(dim, 0, k), a_cur * a_prev], dim)
        b = torch.cat([b.narrow(dim, 0, k), a_cur * b_prev + b_cur], dim)
        k *= 2
    return a, b


def _decay_and_input(dt, A, B_, x, cfg):
    """Per-step decay exp(dt*A) and input dt*x*B, (B, Q, Di, N), in the
    scan dtype."""
    sdt = getattr(torch, cfg.ssm.scan_dtype)
    dA = torch.exp(dt[..., None] * A).to(sdt)
    dBx = ((dt * x)[..., None] * B_[:, :, None, :]).to(sdt)
    return dA, dBx


def _scan_assoc(dt, A, B_, C_, x, h, cfg):
    dA, dBx = _decay_and_input(dt, A, B_, x, cfg)
    a_cum, b_cum = _prefix_scan(dA, dBx, dim=1)
    h_all = a_cum.float() * h[:, None] + b_cum.float()
    y = torch.einsum("bqdn,bqn->bqd", h_all, C_)
    return y, h_all[:, -1]


def _scan_blocked(dt, A, B_, C_, x, h, cfg):
    """The JAX package's blocked scan: (1) each 8-step sub-block's decay
    product and decay-weighted input sum, (2) an inclusive scan over the
    sub-block summaries, (3) the states inside each sub-block rebuilt
    from its entry state."""
    q = x.shape[1]
    if q % SUB:
        return _scan_assoc(dt, A, B_, C_, x, h, cfg)
    dA, dBx = _decay_and_input(dt, A, B_, x, cfg)
    Bn, _, Di, N = dA.shape
    nb = q // SUB
    dA_b = dA.reshape(Bn, nb, SUB, Di, N)
    dBx_b = dBx.reshape(Bn, nb, SUB, Di, N)
    a_blk, b_blk = dA_b[:, :, 0], dBx_b[:, :, 0]
    for t in range(1, SUB):
        a_t = dA_b[:, :, t]
        b_blk = a_t * b_blk + dBx_b[:, :, t]
        a_blk = a_t * a_blk
    a_cum, b_cum = _prefix_scan(a_blk, b_blk, dim=1)
    h0f = h[:, None].float()
    h_t = torch.cat([h0f, a_cum[:, :-1].float() * h0f
                     + b_cum[:, :-1].float()], dim=1)         # (B,nb,Di,N)
    hs = []
    for t in range(SUB):
        h_t = dA_b[:, :, t].float() * h_t + dBx_b[:, :, t].float()
        hs.append(h_t)
    h_all = torch.stack(hs, dim=2).reshape(Bn, q, Di, N)
    y = torch.einsum("bqdn,bqn->bqd", h_all, C_.float())
    return y, a_cum[:, -1].float() * h + b_cum[:, -1].float()


def _chunked(scan):
    """``scan`` run over the sequence in chunks of ``cfg.ssm.chunk``
    steps, the state carried from chunk to chunk."""
    def run(dt, A, B_, C_, x, h, cfg):
        S = x.shape[1]
        Q = min(cfg.ssm.chunk, S)
        if S % Q != 0:
            Q = S      # odd lengths (tests, short prompts): a single chunk
        ys = []
        for c in range(0, S, Q):
            sl = slice(c, c + Q)
            y_c, h = scan(dt[:, sl], A, B_[:, sl], C_[:, sl], x[:, sl], h,
                          cfg)
            ys.append(y_c)
        return torch.cat(ys, dim=1), h
    return run


def _scan_cuda(dt, A, B_, C_, x, h, cfg):
    # dt and x are fresh contiguous (B, S, Di) tensors; B_ and C_ are
    # column slices of one projection, so each is copied (small: (B, S,
    # N)) into a fresh tensor, aligned as the kernel's TMA reads need
    B_, C_ = (t.clone(memory_format=torch.contiguous_format)
              for t in (B_, C_))
    return selective_scan(dt, A, B_, C_, x, h)


_SCANS = {"assoc": _chunked(_scan_assoc), "blocked": _chunked(_scan_blocked),
          "cuda": _scan_cuda}


def mamba1_forward(p: Dict, x, cfg, return_state: bool = False):
    """Full-sequence mamba1 mixer. x: (B, S, D) -> (B, S, D); with
    ``return_state`` also the state after the last position,
    ``{"conv": (B, K-1, Di) compute dtype, "h": (B, Di, N) fp32}``."""
    s = cfg.ssm
    Bn = x.shape[0]
    cdt = cfg.dtype("compute")

    xz = x.to(cdt) @ p["in_proj"].to(cdt)
    xs_pre, z = xz.chunk(2, dim=-1)
    xs = F.silu(_causal_conv(xs_pre, p["conv_w"].to(cdt),
                             p["conv_b"].to(cdt)))
    dt, B_, C_ = _ssm_inputs_m1(p, xs, cfg)
    A = -torch.exp(p["A_log"].float())                        # (Di, N)
    xf = xs.float()

    h = torch.zeros((Bn,) + tuple(A.shape), dtype=torch.float32,
                    device=x.device)
    y, h = _SCANS[s.scan_impl](dt, A, B_, C_, xf, h, cfg)
    y = y + p["D_skip"].float() * xf
    y = y.to(cdt) * F.silu(z)
    out = (y @ p["out_proj"].to(cdt)).to(x.dtype)
    if return_state:
        K = s.d_conv
        pad = F.pad(xs_pre, (0, 0, K - 1, 0))
        return out, {"conv": pad[:, -(K - 1):].to(cdt), "h": h}
    return out


def mamba1_init_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    return {"conv": torch.zeros((batch, s.d_conv - 1, cfg.d_inner),
                                dtype=cfg.dtype("compute"), device=device),
            "h": torch.zeros((batch, cfg.d_inner, s.d_state),
                             dtype=torch.float32, device=device)}


def mamba1_step(p: Dict, x_t, state: Dict, cfg
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single decode step. x_t: (B, D) -> (y, new_state)."""
    cdt = cfg.dtype("compute")
    xz = x_t.to(cdt) @ p["in_proj"].to(cdt)
    xs, z = xz.chunk(2, dim=-1)
    conv_new, xs = _conv_step(state["conv"], xs, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt))
    xs = F.silu(xs)
    dt, B_, C_ = _ssm_inputs_m1(p, xs, cfg)                 # (B,Di),(B,N)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[..., None] * A)                         # (B, Di, N)
    dBx = (dt * xs.float())[..., None] * B_[:, None, :]
    h = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, C_)
    y = y + p["D_skip"].float() * xs.float()
    y = y.to(cdt) * F.silu(z)
    out = y @ p["out_proj"].to(cdt)
    return out.to(x_t.dtype), {"conv": conv_new, "h": h}
