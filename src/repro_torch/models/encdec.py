"""Whisper-style encoder-decoder backbone (the audio family).

Port of ``repro/models/encdec.py`` (``_mlp_params``,
``_enc_block_params``, ``_dec_block_params``, ``build_params``, ``_qkv``,
``_proj_out``, ``encode``, ``_dec_block``, ``forward_features``,
``forward``, ``cross_kv``). The conv frontend is a stub, as in the JAX
package: ``frames`` are precomputed frame embeddings (B, n_frames,
d_model). Positions are unbounded sinusoids on both sides (the JAX
package's recorded deviation from whisper's learned decoder positions).
The output projection is the tied ``embed``.

The stacked encoder and decoder trees (layer dim in front) are driven
a layer at a time by ``transformer._run_layers``, which applies
``cfg.remat`` to each layer step, as the port's transformer does. The
JAX module's ``constrain`` calls have no counterpart: on a mesh,
DTensor's propagation places the activations (``train_loop``), and its
sequence-parallel attention route is a layout choice not ported
(ROADMAP.md).

On a serving mesh's model axis (``split``, ``sharding.serve_slices``)
``encode``, ``_dec_block`` and ``cross_kv`` run on a rank's slices: its
heads of every attention (the cross K/V of its K/V heads), its columns
of each MLP's hidden width. Each sublayer's part is summed over the axis,
the attention's after ``wo`` and the MLP's after ``w_out``, before its
bias ``b_out`` (whole on every rank) is added, once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import attention as attn_lib
from ..dist import sharding as sh
from . import layers, transformer


# =========================== parameters ====================================

def _mlp_params(b, cfg):
    return {"w_in": b.p((cfg.d_model, cfg.d_ff), (sh.EMBED, sh.MLP)),
            "b_in": b.p((cfg.d_ff,), (sh.MLP,), init="zeros"),
            "w_out": b.p((cfg.d_ff, cfg.d_model), (sh.MLP, sh.EMBED),
                         fan_in=cfg.d_ff),
            "b_out": b.p((cfg.d_model,), (sh.EMBED,), init="zeros")}


def _enc_block_params(b, cfg):
    D = cfg.d_model
    return {**transformer.norm_params(b, "layernorm", D, "ln1"),
            "attn": transformer.attn_params(b, cfg, D),
            **transformer.norm_params(b, "layernorm", D, "ln2"),
            "mlp": _mlp_params(b, cfg)}


def _dec_block_params(b, cfg):
    D = cfg.d_model
    return {**transformer.norm_params(b, "layernorm", D, "ln1"),
            "self_attn": transformer.attn_params(b, cfg, D),
            **transformer.norm_params(b, "layernorm", D, "ln2"),
            "cross_attn": transformer.attn_params(b, cfg, D),
            **transformer.norm_params(b, "layernorm", D, "ln3"),
            "mlp": _mlp_params(b, cfg)}


def build_params(cfg, b):
    """The audio family's parameter tree (the JAX package's names and
    layouts): the tied ``embed``, the stacked ``encoder`` and
    ``decoder`` blocks, ``enc_ln`` and ``ln_final`` with their biases."""
    D = cfg.d_model
    return {"embed": b.p((cfg.padded_vocab, D), (sh.VOCAB, sh.EMBED),
                         init="normal", scale=0.02),
            "encoder": _enc_block_params(
                transformer._Stacked(b, cfg.encoder_layers), cfg),
            "decoder": _dec_block_params(
                transformer._Stacked(b, cfg.n_layers), cfg),
            **transformer.norm_params(b, "layernorm", D, "enc_ln"),
            **transformer.norm_params(b, "layernorm", D, "ln_final")}


# =========================== blocks =========================================

def _heads(x, w):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])


def _qkv(p, x, cfg, kv_x=None):
    cdt = cfg.dtype("compute")
    xc = x.to(cdt)
    kvc = xc if kv_x is None else kv_x.to(cdt)
    return _heads(xc, p["wq"]), _heads(kvc, p["wk"]), _heads(kvc, p["wv"])


def _q(p, x, cfg):
    """The query projection alone: the cross-attention of the chunk and
    decode modes, whose K/V come from the cross cache."""
    return _heads(x.to(cfg.dtype("compute")), p["wq"])


def _proj_out(p, out, cfg, x, split=sh.WHOLE):
    """The output projection; on a rank's heads a part of the sum over
    every head, summed over the model axis."""
    B, S, H, hd = out.shape
    o = out.to(cfg.dtype("compute")).reshape(B, S, H * hd)
    o = split.sum_parts(o @ p["wo"].reshape(H * hd, -1), H < cfg.n_heads)
    return sh.keep_grad_layout(o.to(x.dtype))


def _mlp(p, h, cfg, split=sh.WHOLE):
    """The GELU MLP; on a rank's hidden columns its ``w_out`` product is
    a part of the sum, summed over the model axis before ``b_out`` is
    added."""
    m = layers.gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"], None,
                        cfg.dtype("compute"))
    m = split.sum_parts(m, p["w_out"].shape[-2] < cfg.d_ff)
    return sh.keep_grad_layout(m + p["b_out"])


def _attend(q, k, v, cfg, **kw):
    """``chunked_attention`` on this rank's rows and heads on a mesh."""
    return sh.local_heads(lambda q, k, v: attn_lib.chunked_attention(
        q, k, v, q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk, **kw),
        q, k, v)


def encode(params, cfg, frames, split=sh.WHOLE):
    """frames: (B, F, D) stub embeddings -> (B, F, D) encoder output
    (whole on every rank of a model axis)."""
    cdt = cfg.dtype("compute")
    F = frames.shape[1]
    x = frames.to(cdt) + layers.sinusoidal_positions(F, cfg.d_model, cdt,
                                                     frames.device)

    def block(lp, x, i):
        h = layers.layer_norm(x, lp["ln1"], lp["ln1_b"])
        q, k, v = _qkv(lp["attn"], h, cfg)
        a = _attend(q, k, v, cfg, causal=False)
        x = x + _proj_out(lp["attn"], a, cfg, x, split)
        h = layers.layer_norm(x, lp["ln2"], lp["ln2_b"])
        return x + _mlp(lp["mlp"], h, cfg, split).to(x.dtype)

    x = transformer._run_layers(params["encoder"], x, cfg, block)
    return layers.layer_norm(x, params["enc_ln"], params["enc_ln_b"])


def _dec_block(lp, x, cfg, enc_out=None, *, mode="full", self_kv=None,
               cross_kv=None, cur_len=None, chunk_off=None,
               split=sh.WHOLE):
    """One decoder block; returns the new x.

    ``self_kv``/``cross_kv`` are cache layer views (``serve.kv_cache``)
    bound by the engine: this module never touches raw cache arrays, so
    dense and paged self-attention caches flow through the same lines,
    and the views are written in place. The cross cache is a dense
    ``CrossView``, written once a request at admission.

    Modes: ``full`` (teacher forcing: causal self-attention, then
    cross-attention to ``enc_out``); ``prefill`` (the same, writing the
    prompt's self K/V into ``self_kv``); ``chunk`` (a C-token slice at
    per-row offsets ``chunk_off``: its self K/V written at those offsets
    and attended through ``prefill_attention``, the flash-prefill kernel
    on a paged view under ``attn_impl="cuda"``; cross-attention against
    the cached cross K/V, the lanes the one-shot prefill computes fresh
    from ``enc_out``); ``decode`` (one token appended at ``cur_len - 1``
    and attended through ``decode_attention``, the paged-attention
    kernel on a paged view under ``attn_impl="cuda"``; cross-attention
    through the plain path over all ``n_frames`` positions). ``split``:
    the block's weights and cache views are a rank's heads and columns
    (module docstring)."""
    h = layers.layer_norm(x, lp["ln1"], lp["ln1_b"])
    q, k, v = _qkv(lp["self_attn"], h, cfg)
    if mode == "full":
        a = _attend(q, k, v, cfg, causal=True,
                    skip_masked_blocks=cfg.attn_skip_masked_blocks)
    elif mode == "prefill":
        self_kv.write_prompt(k, v)
        a = attn_lib.chunked_attention(q, k, v, causal=True,
                                       q_chunk=cfg.attn_q_chunk,
                                       k_chunk=cfg.attn_k_chunk)
    elif mode == "chunk":
        self_kv.write_chunk(k, v, chunk_off)
        a = attn_lib.prefill_attention(q, self_kv, q_off=chunk_off,
                                       attn_impl=cfg.attn_impl,
                                       k_chunk=cfg.attn_k_chunk)
    elif mode == "decode":
        self_kv.append(k, v, cur_len)
        a = attn_lib.decode_attention(q, self_kv, cur_len=cur_len,
                                      attn_impl=cfg.attn_impl)
    else:
        raise ValueError(mode)
    x = x + _proj_out(lp["self_attn"], a, cfg, x, split)

    # cross-attention to the encoder
    h = layers.layer_norm(x, lp["ln2"], lp["ln2_b"])
    if mode in ("full", "prefill"):
        qc, kc, vc = _qkv(lp["cross_attn"], h, cfg, kv_x=enc_out)
        a = _attend(qc, kc, vc, cfg, causal=False)
    elif mode == "chunk":
        ck, cv = cross_kv.gather()
        a = attn_lib.chunked_attention(_q(lp["cross_attn"], h, cfg), ck, cv,
                                       causal=False,
                                       q_chunk=cfg.attn_q_chunk,
                                       k_chunk=cfg.attn_k_chunk)
    else:
        a = attn_lib.decode_attention(_q(lp["cross_attn"], h, cfg),
                                      cross_kv, cur_len=cross_kv.k.shape[1])
    x = x + _proj_out(lp["cross_attn"], a, cfg, x, split)

    h = layers.layer_norm(x, lp["ln3"], lp["ln3_b"])
    return x + _mlp(lp["mlp"], h, cfg, split).to(x.dtype)


def forward_features(params, cfg, tokens, frames) -> Tuple[torch.Tensor,
                                                           Dict]:
    """Teacher-forced decoder features (final-normed, no unembed) and
    an empty aux dict. tokens: (B, S) int; frames: (B, F, D). The
    embedding table is cast at this use."""
    cdt = cfg.dtype("compute")
    enc_out = encode(params, cfg, frames)
    S = tokens.shape[1]
    x = params["embed"].to(cdt)[tokens] + layers.sinusoidal_positions(
        S, cfg.d_model, cdt, tokens.device)
    x = transformer._run_layers(
        params["decoder"], x, cfg,
        lambda lp, xx, i: _dec_block(lp, xx, cfg, enc_out, mode="full"))
    x = layers.layer_norm(x, params["ln_final"], params["ln_final_b"])
    return x, {}


def forward(params, cfg, tokens, frames) -> Tuple[torch.Tensor, Dict]:
    """Teacher-forced forward: logits (B, S, padded_vocab) through the
    tied embedding, and the aux dict."""
    cdt = cfg.dtype("compute")
    x, aux = forward_features(params, cfg, tokens, frames)
    return x.to(cdt) @ params["embed"].to(cdt).T, aux


def cross_kv(params, cfg, enc_out) -> Dict[str, torch.Tensor]:
    """Every decoder layer's cross-attention K/V of ``enc_out``:
    ``{"k", "v"}``, each (L, B, F, KV, hd) in the compute dtype, the
    same projections the prefill's cross-attention makes (KV the rank's
    heads where its ``wk``/``wv`` are its slices)."""
    e = enc_out.to(cfg.dtype("compute"))
    lps = transformer.layer_params(params["decoder"])
    return {"k": torch.stack([_heads(e, lp["cross_attn"]["wk"])
                              for lp in lps]),
            "v": torch.stack([_heads(e, lp["cross_attn"]["wv"])
                              for lp in lps])}
