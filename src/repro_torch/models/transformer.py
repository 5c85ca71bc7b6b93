"""Decoder-only LM, dense and pure-SSM families: parameters, the
attention block and its modes, the mamba block, and the full-sequence
forward.

Port of ``repro/models/transformer.py`` (``attn_params``,
``mlp_params``, ``_ssm_block_params``, ``build_params``,
``attn_apply``, ``attn_block``, ``ssm_block``, ``forward_features``,
``forward``). The stacked layer
parameters (leading ``L`` dim, as the JAX package stores them) are
driven by a Python loop over layers; ``layer_params`` splits them once
per call into per-layer views. Attention modes:

- ``full``: causal attention over the sequence: the flash-attention
  kernel under ``attn_impl="cuda"`` when S and T are multiples of 128
  (forward only, as in the JAX package), ``chunked_attention``
  otherwise (``resolved_full_attn_impl`` names the path);
- ``prefill``: write the prompt's K/V into the cache view, then attend
  over the prompt itself;
- ``chunk``: write a prompt chunk's K/V at per-row offsets, then attend
  against the cache (``prefill_attention``: the flash-prefill kernel
  through the block table under ``attn_impl="cuda"`` and a paged view);
- ``verify``: write a speculative window's K/V at per-row offsets, then
  score each position as a decode step would (``verify_attention``: the
  chunk kernel's ``flash_verify`` entry under ``attn_impl="cuda"`` and
  a paged view);
- ``decode``: append one token's K/V at ``cur_len - 1``, then attend
  against the cache (``decode_attention``: the paged-attention kernel
  under ``attn_impl="cuda"`` and a paged view).

Cache views, and the SSM state in decode, are written in place (the
JAX package returns new ones).

The full-sequence forward drives the layer stack per
``cfg.layer_loop`` (``_run_layers``): ``scan`` and ``unroll`` are one
Python loop over the layers; ``paper_while`` is ``core.fori_loop``, the
paper's dynamic loop hosting the production model, whose save policy
(``cfg.save_policy``, §5.3 swapping under ``offload``) applies to the
layer activations. ``cfg.remat`` wraps each layer step: ``full`` in a
non-reentrant ``torch.utils.checkpoint`` (only the step's inputs are
saved), ``dots`` in selective activation checkpointing that saves the
matmul outputs, ``attn_out`` in selective checkpointing that saves
only the attention outputs (tagged by ``tag_attn_out``, as the JAX
package's ``checkpoint_name(a, "attn_out")``), ``none`` in nothing.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import core
from ..kernels import ARCH_TAG
from . import attention as attn_lib
from . import layers
from . import ssm as ssm_lib


# =========================== parameters ====================================
# Structure functions over a parameter source ``b`` whose ``b.p(shape,
# init=..., scale=..., fan_in=...)`` draws one tensor
# (``bridge.init_params``), as the JAX package's ``build_params`` runs
# over the parameter factory of its ``models/params.py``.

def attn_params(b, cfg, d_model: int):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # fan_in=d_model: the JAX package's default (shape[-2], the head
    # count here) makes random full-width attention an argmax
    # (bridge.init_params)
    p = {"wq": b.p((d_model, H, hd), fan_in=d_model),
         "wk": b.p((d_model, KV, hd), fan_in=d_model),
         "wv": b.p((d_model, KV, hd), fan_in=d_model),
         "wo": b.p((H, hd, d_model), fan_in=H * hd)}
    if cfg.qkv_bias:
        p["bq"] = b.p((H, hd), init="zeros")
        p["bk"] = b.p((KV, hd), init="zeros")
        p["bv"] = b.p((KV, hd), init="zeros")
    return p


def mlp_params(b, cfg, d_model: int, d_ff: int):
    return {"w_gate": b.p((d_model, d_ff)), "w_up": b.p((d_model, d_ff)),
            "w_down": b.p((d_ff, d_model), fan_in=d_ff)}


def _norm_params(b, kind: str, d: int, name: str):
    if kind == "rmsnorm":
        return {name: b.p((d,), init="ones")}
    if kind == "nonparametric_ln":
        return {}
    raise NotImplementedError(f"norm {kind!r} is not ported yet")


class _Stacked:
    """Wrap a parameter source so every param gains a leading
    (layers,) dim."""

    def __init__(self, b, n: int):
        self._b, self._n = b, n

    def p(self, shape, **kw):
        return self._b.p((self._n, *shape), **kw)


def _ssm_block_params(b, cfg):
    return {**_norm_params(b, cfg.norm, cfg.d_model, "ln"),
            "ssm": ssm_lib.mamba1_params(b, cfg)}


def build_params(cfg, b):
    """The dense or pure-SSM family's parameter tree (the JAX package's
    names and layouts; layer leaves stacked on a leading L dim)."""
    D = cfg.d_model
    lb = _Stacked(b, cfg.n_layers)
    if cfg.family == "ssm":
        layers_p = _ssm_block_params(lb, cfg)
    else:
        layers_p = {**_norm_params(lb, cfg.norm, D, "ln_attn"),
                    "attn": attn_params(lb, cfg, D),
                    **_norm_params(lb, cfg.norm, D, "ln_mlp"),
                    "mlp": mlp_params(lb, cfg, D, cfg.d_ff)}
    p = {"embed": b.p((cfg.padded_vocab, D), init="normal", scale=0.02),
         "layers": layers_p, **_norm_params(b, cfg.norm, D, "ln_final")}
    if not cfg.tie_embeddings:
        p["unembed"] = b.p((D, cfg.padded_vocab), init="normal",
                           scale=0.02)
    return p


def layer_params(stacked: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked layer tree (one ``unbind`` per
    leaf, no copies)."""
    def unbind(t):
        if isinstance(t, dict):
            return {k: unbind(v) for k, v in t.items()}
        return t.unbind(0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    flat = unbind(stacked)
    n = len(next(iter(_leaves(flat))))
    return [pick(flat, i) for i in range(n)]


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def _flash_path(cfg, S: int, T: int) -> bool:
    """Mode ``full`` takes the flash-attention kernel exactly when the
    JAX package takes its Pallas kernel: the kernel path is asked for
    and both lengths are multiples of 128."""
    return cfg.attn_impl == "cuda" and S % 128 == 0 and T % 128 == 0


def resolved_full_attn_impl(cfg, seq_len: int, device) -> str:
    """Which attention mode ``full`` runs at this length:
    "cuda-flash:sm_90a" (the flash-attention kernel on the card),
    "torch-plain-flash:cpu" (its plain version, for CPU tensors) or
    "chunked" (``chunked_attention``)."""
    if not _flash_path(cfg, seq_len, seq_len):
        return "chunked"
    dev = torch.device(device)
    return ("cuda-flash:" + ARCH_TAG if dev.type == "cuda"
            else "torch-plain-flash:" + dev.type)


def attn_apply(p, x, cfg, *, positions, mode: str = "full",
               kv_cache=None, cur_len=None, chunk_off=None):
    """One attention sublayer; returns its output (B, S, d_model) in
    x's dtype. ``kv_cache`` is a cache layer view (``serve.kv_cache``)
    in the prefill, chunk, verify and decode modes."""
    cdt = cfg.dtype("compute")
    xc = x.to(cdt)
    B, S, D = xc.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (xc @ p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (xc @ p["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = (xc @ p["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)

    if mode == "full" and _flash_path(cfg, S, S):
        from ..kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=True)
    elif mode in ("full", "prefill"):
        if mode == "prefill":
            kv_cache.write_prompt(k, v)
        out = attn_lib.chunked_attention(
            q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
            k_chunk=cfg.attn_k_chunk,
            skip_masked_blocks=cfg.attn_skip_masked_blocks)
    elif mode == "chunk":
        kv_cache.write_chunk(k, v, chunk_off)
        out = attn_lib.prefill_attention(q, kv_cache, q_off=chunk_off,
                                         attn_impl=cfg.attn_impl,
                                         k_chunk=cfg.attn_k_chunk)
    elif mode == "verify":
        kv_cache.write_chunk(k, v, chunk_off)
        out = attn_lib.verify_attention(q, kv_cache, q_off=chunk_off,
                                        attn_impl=cfg.attn_impl)
    elif mode == "decode":
        kv_cache.append(k, v, cur_len)
        out = attn_lib.decode_attention(q, kv_cache, cur_len=cur_len,
                                        attn_impl=cfg.attn_impl)
    else:
        raise ValueError(mode)
    out = out.to(cdt).reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return out.to(x.dtype)


@torch.library.custom_op("repro_torch::attn_out", mutates_args=())
def tag_attn_out(a: torch.Tensor) -> torch.Tensor:
    """The attention output's tag for ``remat="attn_out"``: an identity
    that returns a copy (a custom op must not alias its input), one
    (B, S, d_model) tensor per layer. ``_save_attn_out`` saves what it
    returns; its gradient passes the cotangent through."""
    return a.clone()


@tag_attn_out.register_fake
def _(a):
    return torch.empty_like(a)


tag_attn_out.register_autograd(lambda ctx, grad: grad)


def attn_block(p, x, cfg, *, positions, mode="full", kv_cache=None,
               cur_len=None, chunk_off=None):
    """Pre-norm attention + SwiGLU MLP block; returns the new x."""
    h = layers.apply_norm(cfg.norm, x, p, "ln_attn")
    a = attn_apply(p["attn"], h, cfg, positions=positions, mode=mode,
                   kv_cache=kv_cache, cur_len=cur_len, chunk_off=chunk_off)
    if cfg.remat == "attn_out":   # only there: other modes' graphs unchanged
        a = tag_attn_out(a)
    x = x + a
    h = layers.apply_norm(cfg.norm, x, p, "ln_mlp")
    m = layers.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"], cfg.dtype("compute"))
    return x + m.to(x.dtype)


def ssm_block(p, x, cfg, *, mode="full", state=None):
    """Pre-norm mamba block; returns the new x. Mode ``full`` runs the
    mixer over the sequence; mode ``decode`` takes one token (x: (B, 1,
    D)) and updates this layer's ``state`` (``{"conv", "h"}`` views into
    the cache) in place."""
    h = layers.apply_norm(cfg.norm, x, p, "ln")
    if mode == "full":
        y = ssm_lib.mamba1_forward(p["ssm"], h, cfg)
    elif mode == "decode":
        y, new = ssm_lib.mamba1_step(p["ssm"], h[:, 0], state, cfg)
        state["conv"].copy_(new["conv"])
        state["h"].copy_(new["h"])
        y = y[:, None]
    else:
        raise ValueError(mode)
    return x + y


def unembed_weight(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


# =========================== layer loops ====================================

_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing policy of ``remat="dots"``: keep every
    matmul output, recompute the rest (``jax.checkpoint_policies.
    checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_attn_out(ctx, op, *args, **kwargs):
    """Selective checkpointing policy of ``remat="attn_out"``: keep only
    the tagged attention outputs, recompute the rest
    (``jax.checkpoint_policies.save_only_these_names("attn_out")``)."""
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.attn_out.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """Wrap one layer step ``fn(lp, x) -> x`` per ``cfg.remat``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":       # save only the step's inputs
        return functools.partial(checkpoint, fn, use_reentrant=False)
    policies = {"dots": _save_dots, "attn_out": _save_attn_out}
    if cfg.remat in policies:
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, policies[cfg.remat]))
    raise ValueError(cfg.remat)


def _run_layers(stacked, x, cfg, block_fn):
    """Drive the homogeneous layer stack per ``cfg.layer_loop``;
    ``block_fn(lp, x) -> x`` runs one layer."""
    step = _remat(block_fn, cfg)
    lps = layer_params(stacked)
    if cfg.layer_loop in ("scan", "unroll"):
        for lp in lps:
            x = step(lp, x)
        return x
    if cfg.layer_loop == "paper_while":
        return core.fori_loop(0, len(lps), lambda i, xx: step(lps[i], xx),
                              x, save_policy=cfg.save_policy)
    raise ValueError(cfg.layer_loop)


def forward_features(params, cfg, tokens):
    """Backbone + final norm, no unembed. tokens: (B, S) int. The table
    is cast at this use (a no-op on serving weights, already cast)."""
    x = params["embed"].to(cfg.dtype("compute"))[tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None]
    if cfg.family == "ssm":
        def block_fn(lp, xx):
            return ssm_block(lp, xx, cfg, mode="full")
    else:
        def block_fn(lp, xx):
            return attn_block(lp, xx, cfg, positions=positions, mode="full")
    x = _run_layers(params["layers"], x, cfg, block_fn)
    return layers.apply_norm(cfg.norm, x, params, "ln_final")


def forward(params, cfg, tokens):
    """Full-sequence logits (B, S, padded_vocab)."""
    x = forward_features(params, cfg, tokens)
    cdt = cfg.dtype("compute")
    return x.to(cdt) @ unembed_weight(params, cfg).to(cdt)
