"""Adaptive per-token depth: early-exit decode and mixture-of-depths.

Port of ``repro/models/adaptive.py``. Two mechanisms, both driven by
the decode layer loop in ``transformer.decode_layers``:

**Confidence-based early exit** (``cfg.early_exit``): after each
decoder block, a shared-unembed logit-margin check (top1 - top2 of the
final norm and the tied or untied unembed, no new parameters) halts
rows whose margin clears ``cfg.exit_threshold``. The layer loop runs
while any row is live; halted rows carry ``x`` through unchanged, and
their K/V for the layers they skip is filled from the halting layer's
hidden state (``transformer.kv_project_append``), so later full-depth
tokens attend correctly through the paged block table.

**Mixture-of-depths** (``cfg.mod_capacity > 0``): every routed layer
(``i % mod_every == mod_every - 1``) carries a learned scalar router
(``sigmoid(x . w)``). The full-sequence forward keeps the top
``capacity * S`` tokens of a row and scales their block delta by the
gate, so the router weight trains with everything else. Decode
thresholds the same scalar (``g >= 0.5``; the zero init processes
everything until training moves it); a skipped token's K/V is still
written (the block runs on the frozen ``x``, only its output is
masked).

Threshold = inf runs the full halt machinery with no row ever halting
and is bit-identical to the non-adaptive path.

The JAX package's ``check_depth_gating`` walks the jaxpr of a traced
decode step to prove that no attention contraction runs outside the
halt loop. A PyTorch program has no jaxpr; its port is a launch count.
With every row halted after layer ``e``, decode attention runs ``e``
times a step and nothing later attends (the fill is projection only).
On the card that count is the device-side ``count_launch(
"paged_attention")`` of the paged-attention wrapper, which inside a
captured segment adds one only when the layer's IF node is taken; on
the CPU it is the number of ``attention.decode_attention`` calls.
"""

from __future__ import annotations

import math

import torch

from ..dist import sharding as sh
from . import layers


# =========================== gating predicates ==============================

def mod_on(cfg) -> bool:
    """Mixture-of-depths routing active (router params exist)."""
    return cfg.mod_capacity > 0


def enabled(cfg) -> bool:
    """Any adaptive-depth mechanism active for this config."""
    return bool(cfg.early_exit or mod_on(cfg))


def validate(cfg) -> None:
    """Reject configs whose adaptive knobs cannot work (the JAX
    package's messages). Adaptive depth rides the attention-family
    decode layer loop (dense, MoE, VLM); SSM, hybrid and audio decode
    drive other state, and the hybrid's shared block has no per-layer
    identity to route."""
    if not enabled(cfg):
        return
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"adaptive depth (early_exit / mod_capacity) requires an "
            f"attention-decoder family (dense/moe/vlm); got "
            f"{cfg.family!r}")
    if not 1 <= cfg.exit_min_layers <= cfg.n_layers:
        raise ValueError(
            f"exit_min_layers must be in [1, n_layers={cfg.n_layers}]; "
            f"got {cfg.exit_min_layers}")
    if not 0.0 <= cfg.mod_capacity <= 1.0:
        raise ValueError(
            f"mod_capacity must be in [0, 1]; got {cfg.mod_capacity}")
    if mod_on(cfg) and cfg.mod_every < 2:
        raise ValueError(
            f"mod_every must be >= 2 (routing every layer would let "
            f"tokens skip the whole stack); got {cfg.mod_every}")


# =========================== parameters =====================================

def router_params(b, cfg):
    """Per-layer MoD router: one scalar head ``g = sigmoid(x . w)``,
    zero-initialised (``g = 0.5`` everywhere), kept in the param dtype
    (the gate is computed in fp32, as in the JAX package)."""
    return {"w": b.p((cfg.d_model,), (sh.EMBED,), init="zeros",
                     param_dtype=True)}


# =========================== early exit =====================================

def _unembed_weight(params, cfg):
    # transformer.unembed_weight's rule (transformer imports this module)
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def exit_margin(params, cfg, x, split=sh.WHOLE) -> torch.Tensor:
    """(B,) fp32 confidence margin of the shared unembed exit head: the
    model's own final norm and unembed on the mid-stack hidden state,
    top1 - top2 of the logits at the last position, over the padded
    vocab as the JAX package takes it. On a rank's vocabulary columns
    (``split``) the top-2 reads the logits gathered whole, so every rank
    decides alike. Reads ``x``, never writes it."""
    cdt = cfg.dtype("compute")
    h = layers.apply_norm(cfg.norm, x[:, -1], params, "ln_final")
    logits = h.to(cdt) @ _unembed_weight(params, cfg).to(cdt)
    logits = split.gather_vocab(logits, cfg.padded_vocab)
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def make_halt_fn(params, cfg, split=sh.WHOLE):
    """The per-layer halt check for ``transformer.decode_layers`` (None
    when early exit is off). ``halt_fn(x, i) -> (B,) bool`` marks rows
    allowed to halt after layer ``i`` (a Python int): margin above
    ``cfg.exit_threshold`` and at least ``cfg.exit_min_layers`` blocks
    applied. ``decode_layers`` ORs it into its halt vector. ``split`` as
    in ``exit_margin``."""
    if not cfg.early_exit:
        return None
    thr, min_layers = float(cfg.exit_threshold), cfg.exit_min_layers

    def halt_fn(x, i):
        return (i + 1 >= min_layers) & (exit_margin(params, cfg, x, split)
                                         > thr)

    return halt_fn


# =========================== mixture of depths ==============================

def is_routed(i: int, cfg) -> bool:
    """Whether layer ``i`` carries a MoD router."""
    return (i % cfg.mod_every) == (cfg.mod_every - 1)


def _gate(w, x) -> torch.Tensor:
    """(B, S) router scalar in fp32."""
    return torch.sigmoid(torch.einsum("bsd,d->bs", x.float(), w.float()))


def mod_apply_full(router, x_in, x_out, i: int, cfg):
    """Full-sequence MoD: at a routed layer the top-capacity tokens of
    each row keep the gate-scaled block delta ``x_in + g * (x_out -
    x_in)`` and the rest carry ``x_in`` through; ties at the capacity
    threshold over-select (``>=``). The gate multiplies the delta, so
    the router weight receives gradient. Non-routed layers return
    ``x_out``."""
    if not is_routed(i, cfg):
        return x_out
    g = _gate(router["w"], x_in)
    S = x_in.shape[1]
    k_cap = max(1, min(S, math.ceil(cfg.mod_capacity * S)))
    if k_cap >= S:
        sel = torch.ones_like(g, dtype=torch.bool)
    else:
        sel = g >= torch.topk(g, k_cap, dim=-1).values[:, -1:]
    delta = (x_out - x_in) * g.to(x_in.dtype)[..., None]
    return torch.where(sel[..., None], x_in + delta, x_in)


def mod_apply_decode(router, x_in, x_out, i: int, cfg):
    """Decode MoD: top-capacity selection becomes a threshold on the
    scalar (``g >= 0.5``). Returns ``(x, applied)``: skipped rows carry
    ``x_in`` through (their K/V was appended by the block that ran on
    the frozen ``x_in``) and report ``applied=False`` for the depth
    stats; a non-routed layer returns ``(x_out, None)``, every row
    applied."""
    if not is_routed(i, cfg):
        return x_out, None
    g = _gate(router["w"], x_in)[:, -1]
    proc = g >= 0.5
    delta = (x_out - x_in) * g[:, None, None].to(x_in.dtype)
    return torch.where(proc[:, None, None], x_in + delta, x_in), proc
