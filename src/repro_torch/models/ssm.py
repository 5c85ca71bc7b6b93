"""Mamba mixers: mamba1 (the selective scan) for the pure-SSM family,
mamba2 (the SSD chunk decomposition) for the hybrid.

Port of ``repro/models/ssm.py`` (``mamba1_params``, ``_causal_conv``,
``_conv_step``, ``_ssm_inputs_m1``, ``mamba1_forward``,
``mamba1_init_state``, ``mamba1_step``, ``mamba2_params``,
``_split_m2``, ``mamba2_forward``, ``mamba2_init_state``,
``mamba2_step``). Same arithmetic: the projections and the causal conv
run in the compute dtype, the recurrence in fp32 with ``A_log``,
``dt_bias`` and ``D_skip`` kept in fp32 (``bridge`` leaves these three
in the param dtype, and mamba2's ``norm_w``, the RMSNorm after its
gate).

``cfg.ssm.scan_impl`` picks mamba1's recurrence:

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

mamba2 (``mamba2_forward``) has a scalar decay a head, so a chunk of Q
steps is matrix products (the SSD block decomposition): the intra-chunk
part through the (Q, Q) decay-masked score matrix, the carried state's
part, and the state at the chunk's end, in fp32, chunk by chunk in a
Python loop. These are plain products (``torch.einsum``), as the JAX
package computes them outside any Pallas kernel. The chunk rule is the
JAX package's: ``Q = min(chunk, S)``, and one chunk of the whole
sequence when S is not a multiple, so an odd-length prompt rounds as
one chunk.

Decode (``mamba1_step``, ``mamba2_step``) is one state update per
token; ``mixer_forward``, ``mixer_step`` and ``init_state`` pick the
mixer by ``cfg.ssm.kind``.

On a serving mesh's model axis (``split``, ``sharding.serve_slices``)
each mixer runs on a rank's slices of its weights, where ``INNER``
splits them: mamba1 on its Di/m channels (its x and z from its own
``in_proj`` columns, the conv, ``dt_proj``, ``A_log``, ``D_skip`` and the
scan on them; ``x_proj``'s (dt_low, B, C), a part of a sum over the
channels, summed over the axis before ``dt_proj``); mamba2 on its H/m
heads (z, x and dt of them; B and C whole on every rank, so its conv
runs on its x channels and the whole B and C channels; ``A_log``,
``dt_bias`` and ``D_skip``, whole, read at its head offset; the gated
RMSNorm's mean over the whole Di from the ranks' sums of squares).
``out_proj``'s part is summed after the mixer. ``serve_parts`` lists the
leaves that concatenate several tensors along ``INNER``, which the
slicer cuts part by part. The state then holds the rank's channels:
mamba1's conv (B, K-1, Di/m) and h (B, Di/m, N), mamba2's conv (B, K-1,
Di/m + 2N) and h (B, H/m, P, N).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan.ops import selective_scan
from ..dist import sharding as sh

# leaves the JAX package reads in fp32 whatever the compute dtype
PARAM_DTYPE_LEAVES = ("A_log", "dt_bias", "D_skip")
# mamba2's RMSNorm weight after the gate, read in fp32 as every norm
NORM_LEAVES = ("norm_w",)
SUB = 8          # sub-block length of the blocked scan


def mamba1_params(b, cfg):
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    dt_rank = max(1, math.ceil(d / 16))
    return {
        "in_proj": b.p((d, 2 * di), (sh.EMBED, sh.INNER)),
        "conv_w": b.p((s.d_conv, di), (None, sh.INNER), init="normal",
                      scale=0.2),
        "conv_b": b.p((di,), (sh.INNER,), init="zeros"),
        "x_proj": b.p((di, dt_rank + 2 * s.d_state), (sh.INNER, None)),
        "dt_proj": b.p((dt_rank, di), (None, sh.INNER)),
        "dt_bias": b.p((di,), (sh.INNER,), init="zeros", param_dtype=True),
        "A_log": b.p((di, s.d_state), (sh.INNER, sh.STATE), init="normal",
                     scale=0.5, param_dtype=True),
        "D_skip": b.p((di,), (sh.INNER,), init="ones", param_dtype=True),
        "out_proj": b.p((di, d), (sh.INNER, sh.EMBED)),
    }


def serve_parts(cfg) -> Dict[str, tuple]:
    """The mixer's leaves that concatenate several tensors along their
    ``INNER`` dim, each as its parts ``((width, split over model),
    ...)`` in order (``sharding.serve_slices``): mamba1's ``in_proj`` is
    ``[x | z]``; mamba2's is ``[z | x | B | C | dt]``, and its conv's
    channels ``[x | B | C]``, B and C (N each) whole on every rank and dt
    one entry a head."""
    s, di = cfg.ssm, cfg.d_inner
    if s.kind == "mamba1":
        return {"in_proj": ((di, True), (di, True))}
    xbc = ((di, True), (s.d_state, False), (s.d_state, False))
    return {"in_proj": ((di, True),) + xbc + ((di // s.head_dim, True),),
            "conv_w": xbc, "conv_b": xbc}


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


def _ssm_inputs_m1(p, x, cfg, split=sh.WHOLE):
    """Shared preamble: (dt, B, C) from the conv'd activations, fp32. On
    a rank's channels ``x_proj``'s product is a part of the sum over
    every channel, summed over the model axis."""
    s = cfg.ssm
    dt_rank = p["dt_proj"].shape[0]
    dbc = split.sum_parts(x @ p["x_proj"].to(x.dtype),
                          p["x_proj"].shape[0] < cfg.d_inner)
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


def _out(p, y, cfg, split):
    """``out_proj``, whose product on a rank's channels is a part of the
    sum over every channel, summed over the model axis."""
    return split.sum_parts(y @ p["out_proj"].to(y.dtype),
                           p["out_proj"].shape[0] < cfg.d_inner)


def mamba1_forward(p: Dict, x, cfg, return_state: bool = False,
                   split=sh.WHOLE):
    """Full-sequence mamba1 mixer. x: (B, S, D) -> (B, S, D); with
    ``return_state`` also the state after the last position,
    ``{"conv": (B, K-1, Di) compute dtype, "h": (B, Di, N) fp32}`` (Di
    the rank's channels on a model axis, module docstring)."""
    s = cfg.ssm
    Bn = x.shape[0]
    cdt = cfg.dtype("compute")

    xz = x.to(cdt) @ p["in_proj"].to(cdt)
    xs_pre, z = xz.chunk(2, dim=-1)
    xs = F.silu(_causal_conv(xs_pre, p["conv_w"].to(cdt),
                             p["conv_b"].to(cdt)))
    dt, B_, C_ = _ssm_inputs_m1(p, xs, cfg, split)
    A = -torch.exp(p["A_log"].float())                        # (Di, N)
    xf = xs.float()

    h = torch.zeros((Bn,) + tuple(A.shape), dtype=torch.float32,
                    device=x.device)
    y, h = _SCANS[s.scan_impl](dt, A, B_, C_, xf, h, cfg)
    y = y + p["D_skip"].float() * xf
    y = y.to(cdt) * F.silu(z)
    out = _out(p, y, cfg, split).to(x.dtype)
    if return_state:
        K = s.d_conv
        pad = F.pad(xs_pre, (0, 0, K - 1, 0))
        return out, {"conv": pad[:, -(K - 1):].to(cdt), "h": h}
    return out


def mamba1_init_state(cfg, batch: int, device, inner: int = 0
                      ) -> Dict[str, torch.Tensor]:
    s, di = cfg.ssm, inner or cfg.d_inner
    return {"conv": torch.zeros((batch, s.d_conv - 1, di),
                                dtype=cfg.dtype("compute"), device=device),
            "h": torch.zeros((batch, di, s.d_state),
                             dtype=torch.float32, device=device)}


def mamba1_step(p: Dict, x_t, state: Dict, cfg, split=sh.WHOLE
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single decode step. x_t: (B, D) -> (y, new_state)."""
    cdt = cfg.dtype("compute")
    xz = x_t.to(cdt) @ p["in_proj"].to(cdt)
    xs, z = xz.chunk(2, dim=-1)
    conv_new, xs = _conv_step(state["conv"], xs, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt))
    xs = F.silu(xs)
    dt, B_, C_ = _ssm_inputs_m1(p, xs, cfg, split)          # (B,Di),(B,N)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[..., None] * A)                         # (B, Di, N)
    dBx = (dt * xs.float())[..., None] * B_[:, None, :]
    h = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, C_)
    y = y + p["D_skip"].float() * xs.float()
    y = y.to(cdt) * F.silu(z)
    return _out(p, y, cfg, split).to(x_t.dtype), {"conv": conv_new, "h": h}


# =========================== Mamba-2 (SSD) =================================

def mamba2_params(b, cfg):
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    H, N = di // s.head_dim, s.d_state
    conv_dim = di + 2 * N
    return {
        "in_proj": b.p((d, 2 * di + 2 * N + H), (sh.EMBED, sh.INNER)),
        "conv_w": b.p((s.d_conv, conv_dim), (None, sh.INNER), init="normal",
                      scale=0.2),
        "conv_b": b.p((conv_dim,), (sh.INNER,), init="zeros"),
        "A_log": b.p((H,), (None,), init="normal", scale=0.5,
                     param_dtype=True),
        "dt_bias": b.p((H,), (None,), init="zeros", param_dtype=True),
        "D_skip": b.p((H,), (None,), init="ones", param_dtype=True),
        "norm_w": b.p((di,), (sh.INNER,), init="ones"),
        "out_proj": b.p((di, d), (sh.INNER, sh.EMBED)),
    }


def _split_m2(zxbcdt, di: int, N: int):
    """(z, xBC, dt_raw) of the input projection: widths ``di`` (the
    rank's channels), di + 2N and the rank's head count."""
    return torch.split(zxbcdt, [di, di + 2 * N, zxbcdt.shape[-1] - 2 * di
                                - 2 * N], dim=-1)


def _heads_m2(p, cfg, split):
    """(the rank's channels di, its heads H, and its heads' ``A_log``,
    ``dt_bias`` and ``D_skip``: whole leaves, read at the whole model's
    offset of its first head)."""
    di = p["out_proj"].shape[0]
    H = di // cfg.ssm.head_dim
    h0 = split.offset(H, cfg.d_inner // cfg.ssm.head_dim)
    return (di, H) + tuple(p[k][h0:h0 + H]
                           for k in ("A_log", "dt_bias", "D_skip"))


def _ssd_chunk(h, la_c, B_c, C_c, dtx_c, causal):
    """One chunk of the SSD decomposition. h: (B, H, P, N) fp32 state;
    la_c (B, Q, H) log-decays, B_c/C_c (B, Q, N), dtx_c (B, Q, H, P).
    Returns (state at the chunk's end, y (B, Q, H, P))."""
    cum = torch.cumsum(la_c, dim=1)                           # (B, Q, H)
    # L[i, j] = exp(cum_i - cum_j) for i >= j; the masked entries are
    # exp(-inf) = 0, so no inf reaches a product or its gradient
    diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B, Q, Q, H)
    L = torch.exp(diff.masked_fill(~causal[None, :, :, None], -math.inf))
    sc = torch.einsum("bin,bjn->bij", C_c, B_c)
    y_intra = torch.einsum("bijh,bjhp->bihp", sc[..., None] * L, dtx_c)
    y_inter = torch.einsum("bin,bhpn->bihp", C_c, h) * \
        torch.exp(cum)[..., None]
    decay_end = torch.exp(cum[:, -1:, :] - cum)               # (B, Q, H)
    h_new = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("bjn,bjhp->bhpn", B_c,
                            dtx_c * decay_end[..., None]))
    return h_new, y_intra + y_inter


def mamba2_forward(p: Dict, x, cfg, return_state: bool = False,
                   split=sh.WHOLE):
    """Full-sequence mamba2 mixer (SSD, chunk by chunk). x: (B, S, D) ->
    (B, S, D); with ``return_state`` also the state after the last
    position, ``{"conv": (B, K-1, Di + 2N) compute dtype, "h": (B, H, P,
    N) fp32}`` (Di and H the rank's on a model axis, module
    docstring)."""
    s = cfg.ssm
    Bn, S, _ = x.shape
    cdt = cfg.dtype("compute")
    P, N = s.head_dim, s.d_state
    di, H, A_log, dt_bias, D_skip = _heads_m2(p, cfg, split)
    Q = min(s.chunk, S)
    if S % Q != 0:
        Q = S      # odd lengths (tests, short prompts): a single chunk

    zxbcdt = x.to(cdt) @ p["in_proj"].to(cdt)
    z, xBC_pre, dt_raw = _split_m2(zxbcdt, di, N)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt)))
    xs, B_, C_ = torch.split(xBC, [di, N, N], dim=-1)
    xf = xs.reshape(Bn, S, H, P).float()
    dt = F.softplus(dt_raw.float() + dt_bias.float())         # (B, S, H)
    la = dt * -torch.exp(A_log.float())                       # log-decay
    Bf, Cf = B_.float(), C_.float()
    dtx = dt[..., None] * xf                                  # (B, S, H, P)

    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((Bn, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(0, S, Q):
        sl = slice(c, c + Q)
        h, y_c = _ssd_chunk(h, la[:, sl], Bf[:, sl], Cf[:, sl], dtx[:, sl],
                            causal)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    y = y + D_skip.float()[:, None] * xf
    y = y.reshape(Bn, S, di).to(cdt) * F.silu(z)
    y = split.rms_norm(y, p["norm_w"], cfg.d_inner)
    out = _out(p, y.to(cdt), cfg, split).to(x.dtype)
    if return_state:
        K = s.d_conv
        pad = F.pad(xBC_pre, (0, 0, K - 1, 0))
        return out, {"conv": pad[:, -(K - 1):].to(cdt), "h": h}
    return out


def mamba2_init_state(cfg, batch: int, device, inner: int = 0
                      ) -> Dict[str, torch.Tensor]:
    s, di = cfg.ssm, inner or cfg.d_inner
    H = di // s.head_dim
    return {"conv": torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state),
                                dtype=cfg.dtype("compute"), device=device),
            "h": torch.zeros((batch, H, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device)}


def mamba2_step(p: Dict, x_t, state: Dict, cfg, split=sh.WHOLE
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single decode step. x_t: (B, D) -> (y, new_state)."""
    s = cfg.ssm
    cdt = cfg.dtype("compute")
    P, N = s.head_dim, s.d_state
    di, H, A_log, dt_bias, D_skip = _heads_m2(p, cfg, split)
    zxbcdt = x_t.to(cdt) @ p["in_proj"].to(cdt)
    z, xBC, dt_raw = _split_m2(zxbcdt, di, N)
    conv_new, xBC = _conv_step(state["conv"], xBC, p["conv_w"].to(cdt),
                               p["conv_b"].to(cdt))
    xBC = F.silu(xBC)
    xs, B_, C_ = torch.split(xBC, [di, N, N], dim=-1)
    xs = xs.reshape(-1, H, P).float()
    dt = F.softplus(dt_raw.float() + dt_bias.float())         # (B, H)
    dA = torch.exp(dt * -torch.exp(A_log.float()))            # (B, H)
    h = (dA[..., None, None] * state["h"]
         + (xs * dt[..., None])[..., None] * B_.float()[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", C_.float(), h)
    y = y + D_skip.float()[:, None] * xs
    y = y.reshape(-1, di).to(cdt) * F.silu(z)
    y = split.rms_norm(y, p["norm_w"], cfg.d_inner)
    return _out(p, y.to(cdt), cfg, split).to(x_t.dtype), {"conv": conv_new,
                                                           "h": h}


# =========================== by kind ========================================

def mixer_forward(p: Dict, x, cfg, return_state: bool = False,
                  split=sh.WHOLE):
    """``mamba1_forward`` or ``mamba2_forward`` by ``cfg.ssm.kind``."""
    fwd = mamba1_forward if cfg.ssm.kind == "mamba1" else mamba2_forward
    return fwd(p, x, cfg, return_state=return_state, split=split)


def mixer_step(p: Dict, x_t, state: Dict, cfg, split=sh.WHOLE):
    """``mamba1_step`` or ``mamba2_step`` by ``cfg.ssm.kind``."""
    step = mamba1_step if cfg.ssm.kind == "mamba1" else mamba2_step
    return step(p, x_t, state, cfg, split)


def init_state(cfg, batch: int, device, inner: int = 0
               ) -> Dict[str, torch.Tensor]:
    """``mamba1_init_state`` or ``mamba2_init_state`` by kind; ``inner``
    is a rank's channels on a model axis (0: ``cfg.d_inner``)."""
    init = (mamba1_init_state if cfg.ssm.kind == "mamba1"
            else mamba2_init_state)
    return init(cfg, batch, device, inner)
