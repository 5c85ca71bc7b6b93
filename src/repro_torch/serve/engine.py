"""Serving engine, every family (dense, MoE, VLM, pure-SSM, hybrid and
audio): caches, prefill, chunked prefill, single-token decode, the
speculative verify window, and the batch-synchronous generation loop.

Port of ``repro/serve/engine.py``. Self-attention K/V lives behind the
``serve.kv_cache`` API: ``make_cache`` builds ``{"attn": KVCache}`` for
the attention-decoder families (dense, MoE, VLM) and
every layer reads and writes its slice through a view, so the dense and
paged layouts share every line of attention math. A pure-SSM model's
cache is ``{"ssm": {"conv", "h"}}``: plain per-row state with the layer
dim first and the batch dim at axis 1 of every leaf, the invariant the
scheduler's admission splice relies on. The hybrid's cache holds both:
``attn`` with one layer per application of its shared block
(``ceil(n_layers / shared_attn_every)``), and the mamba2 ``ssm`` state;
it prefills one-shot only and never verifies, as in the JAX package.
The audio family's cache is ``{"self": KVCache, "cross": {"k", "v"}}``:
the decoder's self-attention K/V behind the ``KVCache`` API (one layer
per decoder layer), and the cross-attention K/V of the encoder output,
``(L, batch, n_frames, KV, hd)`` with the batch dim at axis 1, which
``prefill`` returns fresh for the caller to splice and every decode
step reads through the plain path (``kv_cache.CrossView``). A VLM
request's patch embeddings (``prefix_embeds``) occupy stream
positions ``[0, n_patches)`` ahead of its tokens, in ``prefill`` and
``prefill_chunk`` alike. The caches are updated in
place, so the decode and chunk steps return logits only; ``prefill``
also returns the SSM state it computed, fresh, for the caller to splice.

On a serving mesh's model axis (``split``, ``sharding.serve_slices``)
every family runs on a rank's slices of the weights, and its cache holds
the rank's part: the K/V heads of each ``KVCache`` and of the cross K/V
(``CACHE_KV``), the SSM state's channels (``INNER``: mamba1's Di/m,
mamba2's H/m heads, its conv window the rank's x channels and the whole B
and C), as ``make_cache(kv_heads=, inner=)`` sizes them.

``decode_step`` accepts an int ``cur_len`` (whole batch in lockstep) or
a per-row ``(B,)`` int32 tensor (slot pool at mixed depths); the audio
family adds the sinusoid of each row's position, computed on the device
from ``cur_len``. With
adaptive depth (``models.adaptive``) it runs
``transformer.decode_layers`` and can return each row's depth.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..configs import ModelConfig, require_ported
from ..dist import sharding as sh
from ..kernels import ARCH_TAG
from ..models import adaptive, encdec, layers, ssm as ssm_lib, transformer
from . import kv_cache as kvc
from . import sampling as sampling_lib


def _ssm_struct(cfg: ModelConfig, batch: int, device,
                inner: int = 0) -> Dict[str, Any]:
    """Zeroed SSM state of every layer, the layer dim first: mamba1's
    conv (L, batch, K-1, Di) and h (L, batch, Di, N), mamba2's conv (L,
    batch, K-1, Di + 2N) and h (L, batch, H, P, N); conv in the compute
    dtype, h fp32. ``inner``: a rank's channels Di (0: all)."""
    one = ssm_lib.init_state(cfg, batch, device, inner)
    return {k: v.new_zeros((cfg.n_layers,) + v.shape)
            for k, v in one.items()}


def _cross_struct(cfg: ModelConfig, batch: int, device,
                  kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed cross-attention K/V of every decoder layer, ``{"k", "v"}``
    each (L, batch, n_frames, KV, hd) in the compute dtype (KV a rank's
    ``kv_heads``, default all)."""
    shape = (cfg.n_layers, batch, cfg.n_frames, kv_heads or cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {k: torch.zeros(shape, dtype=cfg.dtype("compute"), device=device)
            for k in ("k", "v")}


# the attention-decoder families: one KVCache, decode/verify/chunk modes
ATTN_FAMILIES = ("dense", "moe", "vlm")


def kv_key(cfg: ModelConfig) -> Optional[str]:
    """Cache-dict key of the family's self-attention ``KVCache`` (None
    for pure-SSM families, which have no attention K/V)."""
    return {"dense": "attn", "moe": "attn", "vlm": "attn",
            "hybrid": "attn", "audio": "self", "ssm": None}[cfg.family]


def _attn_layer_count(cfg: ModelConfig) -> int:
    """Layers of the K/V cache: one per application of the hybrid's
    shared block, else one per layer."""
    if cfg.family == "hybrid":
        return len(transformer.hybrid_segments(cfg))
    return cfg.n_layers


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_impl: str = "dense", kv_block: int = 16,
               kv_blocks: Optional[int] = None, kv_sharing: bool = False,
               kv_heads: Optional[int] = None, inner: int = 0,
               device="cuda") -> Dict[str, Any]:
    """``{"attn": KVCache}`` for the attention-decoder families,
    ``{"ssm": {"conv", "h"}}`` for pure SSM, both for the hybrid,
    ``{"self": KVCache, "cross": {"k", "v"}}`` for the audio family.
    ``kv_impl`` selects the K/V layout ("dense" | "paged"),
    ``kv_block``/``kv_blocks`` size the paged pool (``kv_blocks=None``:
    dense-equivalent capacity), ``kv_sharing`` lets its rows share
    blocks (the prefix cache), ``kv_heads`` is a rank's K/V heads under
    a split of ``CACHE_KV`` over the model axis (``local_kv_heads``;
    default: all of them), in the self and the cross K/V alike, and
    ``inner`` its SSM channels under a split of ``INNER``
    (``local_inner``; 0: all of them)."""
    require_ported(cfg)
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = _ssm_struct(cfg, batch, resolve_device(device), inner)
    if cfg.family == "audio":
        out["cross"] = _cross_struct(cfg, batch, resolve_device(device),
                                     kv_heads)
    if kv_key(cfg) is not None:
        out[kv_key(cfg)] = kvc.make_kv_cache(
            cfg, _attn_layer_count(cfg), batch, max_len, impl=kv_impl,
            block=kv_block, n_blocks=kv_blocks, sharing=kv_sharing,
            kv_heads=kv_heads, device=device)
    return out


def local_kv_heads(params, cfg: ModelConfig) -> Optional[int]:
    """The K/V heads of a family's self-attention as a rank holds its
    parameters: ``cfg.n_kv_heads``, or its share under a split of
    ``KV_HEADS`` over the model axis (``sharding.serve_slices``); None
    for the pure-SSM family, which has none."""
    if cfg.family == "ssm":
        return None
    wk = (params["shared_attn"]["attn"]["wk"] if cfg.family == "hybrid"
          else params["decoder"]["self_attn"]["wk"] if cfg.family == "audio"
          else params["layers"]["attn"]["wk"])
    return wk.shape[-2]


def local_inner(params, cfg: ModelConfig) -> int:
    """The SSM channels a rank's mixer parameters hold: ``cfg.d_inner``,
    or its share under a split of ``INNER``; 0 for the families without
    a mixer."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    return params["layers"]["ssm"]["out_proj"].shape[-2]


def _state_axes(cfg: ModelConfig, key: str, leaf: str, row_axis) -> tuple:
    """The logical axes of a per-row cache leaf (the JAX package's
    ``_ssm_struct``/``_cross_struct`` axes): the SSM state's channels or
    heads on ``INNER``, the cross K/V's heads on ``CACHE_KV``."""
    if key == "cross":
        return (sh.LAYERS, row_axis, None, sh.CACHE_KV, sh.CACHE_HD)
    if leaf == "conv":
        return (sh.LAYERS, row_axis, None, sh.INNER)
    if cfg.ssm.kind == "mamba1":
        return (sh.LAYERS, row_axis, sh.INNER, sh.STATE)
    return (sh.LAYERS, row_axis, sh.INNER, None, sh.STATE)


def cache_shardings(cfg: ModelConfig, rules, mesh=None, *, cache,
                    row_axis: Optional[str] = sh.BATCH) -> Dict[str, Any]:
    """DTensor placements matching a ``make_cache`` tree under ``rules``
    (the JAX package's ``cache_shardings``): a ``KVCache`` node gives its
    own (``shardings``), the SSM state and the audio family's cross K/V
    put their row dim (axis 1) on ``row_axis`` (the scheduler passes
    ``SLOT``), the state's channels on ``INNER`` and the cross K/V's
    heads on ``CACHE_KV``. ``cache`` is the tree to mirror, at the global
    row count (a cache on the "meta" device costs nothing). mamba2's conv
    window under ``INNER`` holds each rank's x channels beside the whole
    B and C (``models.ssm``), so its placement reads the ranks' windows
    side by side, not a cut of one window."""
    out: Dict[str, Any] = {}
    for key, node in cache.items():
        if hasattr(node, "shardings"):
            out[key] = node.shardings(rules, mesh, row_axis=row_axis)
        else:
            out[key] = {leaf: rules.sharding(
                _state_axes(cfg, key, leaf, row_axis), mesh,
                dims=tuple(t.shape)) for leaf, t in node.items()}
    return out


def _logits_head(params, cfg: ModelConfig, x, rules=None, split=sh.WHOLE):
    """Final norm + (tied / untied) unembed; the audio family's is its
    layer norm with bias, then the tied embedding. ``rules`` lays the
    logits out (BATCH, -, VOCAB) on a mesh; a no-op off one. On a rank's
    vocabulary columns (``split``) the logits are gathered whole over
    the model axis, the same on every rank."""
    x = layers.apply_norm(cfg.norm, x, params, "ln_final")
    logits = x.to(cfg.dtype("compute")) @ transformer.unembed_weight(
        params, cfg)
    logits = split.gather_vocab(logits, cfg.padded_vocab)
    return sh.constrain(logits, rules, (sh.BATCH, None, sh.VOCAB))


def _embed(params, cfg: ModelConfig, tokens, split=sh.WHOLE):
    """The token embeddings: the vocab-parallel lookup on a rank's
    embedding rows (``split``), else the plain one."""
    return split.embed(params["embed"], tokens, cfg.padded_vocab)


def _decode_positions(cur_len, device):
    """(1, 1) positions for an int ``cur_len``; (B, 1) for a tensor."""
    if torch.is_tensor(cur_len):
        return (cur_len.long() - 1)[:, None]
    return torch.full((1, 1), int(cur_len) - 1, dtype=torch.long,
                      device=device)


def _decode_attn_families(params, cfg, x, cache, cur_len, write_mask,
                          live=None, split=sh.WHOLE):
    """The layer loop of a decode step; returns ``(x, depth)``. Without
    adaptive depth it is a Python loop over the layers and depth is
    None (every row ran every layer); with it,
    ``transformer.decode_layers`` with the mixture-of-depths block, the
    early-exit halt check and the skipped-layer K/V fill."""
    positions = _decode_positions(cur_len, x.device)
    start = (cur_len - 1) if torch.is_tensor(cur_len) else int(cur_len) - 1
    node = cache["attn"].ensure_private(start=start, width=1,
                                        mask=write_mask)
    lps = transformer.layer_params(params["layers"])
    if not adaptive.enabled(cfg):
        for i, lp in enumerate(lps):
            x = transformer.attn_block(
                lp, x, cfg, positions=positions, mode="decode",
                kv_cache=node.view(i, mask=write_mask), cur_len=cur_len,
                split=split)
        return x, None

    def block_fn(lp, xx, i):
        x2 = transformer.attn_block(
            lp, xx, cfg, positions=positions, mode="decode",
            kv_cache=node.view(i, mask=write_mask), cur_len=cur_len,
            split=split)
        if adaptive.mod_on(cfg):
            return adaptive.mod_apply_decode(lp["router"], xx, x2, i, cfg)
        return x2, None

    halt_fn = adaptive.make_halt_fn(params, cfg, split)
    kv_fill_fn = None
    if halt_fn is not None:
        # skipped-layer K/V: the frozen hidden state projected into each
        # remaining layer's cache (no q, attention or MLP)
        def kv_fill_fn(lp, xx, i):
            h = layers.apply_norm(cfg.norm, xx, lp, "ln_attn")
            transformer.kv_project_append(
                lp["attn"], h, cfg, node.view(i, mask=write_mask),
                positions, cur_len)

    return transformer.decode_layers(lps, x, cfg, block_fn=block_fn,
                                     halt_fn=halt_fn, kv_fill_fn=kv_fill_fn,
                                     live=live)


def _decode_ssm(params, cfg, x, cache, layers_=None, split=sh.WHOLE):
    """The layer loop of a pure-SSM decode step (or of ``layers_``, a
    range of them); each layer updates its slice of the cache's conv and
    h state in place."""
    st = cache["ssm"]
    lps = transformer.layer_params(params["layers"])
    for i in (range(len(lps)) if layers_ is None else layers_):
        x = transformer.ssm_block(lps[i], x, cfg, mode="decode",
                                  state={"conv": st["conv"][i],
                                         "h": st["h"][i]}, split=split)
    return x


def _decode_hybrid(params, cfg, x, cache, cur_len, split=sh.WHOLE):
    """The hybrid's decode step: one copy-on-write for the step, then at
    application ``a`` the shared block against cache layer ``a`` and
    that segment's mamba2 steps."""
    positions = _decode_positions(cur_len, x.device)
    start = (cur_len - 1) if torch.is_tensor(cur_len) else int(cur_len) - 1
    node = cache["attn"].ensure_private(start=start, width=1)
    for app, seg in enumerate(transformer.hybrid_segments(cfg)):
        x = transformer.attn_block(
            params["shared_attn"], x, cfg, positions=positions,
            mode="decode", kv_cache=node.view(app), cur_len=cur_len,
            split=split)
        x = _decode_ssm(params, cfg, x, cache, seg, split)
    return x


def _decode_audio(params, cfg, x, cache, cur_len, split=sh.WHOLE):
    """The audio family's decode step: the sinusoid of each row's
    position (``cur_len - 1``, on the device), one copy-on-write for the
    step, then each decoder layer against its self-attention cache
    layer and its cross K/V."""
    start = (cur_len - 1) if torch.is_tensor(cur_len) else int(cur_len) - 1
    pe = layers.sinusoid_at(torch.as_tensor(start, device=x.device),
                            cfg.d_model, cfg.dtype("compute"))
    x = x + (pe if pe.dim() == 1 else pe[:, None, :])
    node = cache["self"].ensure_private(start=start, width=1)
    cross = cache["cross"]
    for i, lp in enumerate(transformer.layer_params(params["decoder"])):
        x = encdec._dec_block(
            lp, x, cfg, mode="decode", self_kv=node.view(i),
            cross_kv=kvc.CrossView(cross["k"][i], cross["v"][i]),
            cur_len=cur_len, split=split)
    return x


def decode_step(params, cfg: ModelConfig, token, cache, cur_len, *,
                write_mask=None, live=None, with_depth: bool = False,
                rules=None, split=sh.WHOLE):
    """One new token against a cache of ``cur_len - 1`` positions.

    token: (B, 1) int. Returns logits (B, 1, padded_vocab), or ``(logits,
    depth)`` with ``with_depth``: depth (B,) int32 counts the decoder
    blocks applied a row (``n_layers`` unless adaptive depth is on; see
    ``models.adaptive``). The cache is updated in place.

    ``write_mask`` (B,) bool (attention families only) gates which rows'
    K/V append lands: the chunked-prefill scheduler decodes the whole
    pool while some slots are mid-prefill, whose stale ``cur_len``
    points into their own prompt. ``live`` (B,) bool (adaptive depth
    only): the rows that keep the adaptive layer loop alive; retired and
    mid-prefill slots pass False, start halted and extend no loop (None:
    every row). ``rules`` lays the logits out on a mesh, as in the JAX
    package; off a mesh (and on a rank's local rows) a no-op. ``split``:
    the params are a rank's slices on a serving mesh's model axis
    (``sharding.serve_slices``), the cache holds its K/V heads and SSM
    channels (``make_cache``), and the logits come back whole."""
    if write_mask is not None and cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"write_mask is only supported for attention "
                         f"families; got family {cfg.family!r}")
    if adaptive.enabled(cfg):
        adaptive.validate(cfg)
    elif live is not None:
        raise ValueError("live= requires adaptive depth "
                         "(cfg.early_exit / cfg.mod_capacity)")
    x = _embed(params, cfg, token, split)
    depth = None
    if cfg.family == "ssm":
        x = _decode_ssm(params, cfg, x, cache, split=split)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, x, cache, cur_len, split)
    elif cfg.family == "audio":
        x = _decode_audio(params, cfg, x, cache, cur_len, split)
    else:
        x, depth = _decode_attn_families(params, cfg, x, cache, cur_len,
                                         write_mask, live, split)
    logits = _logits_head(params, cfg, x, rules, split)
    if not with_depth:
        return logits
    if depth is None:
        depth = torch.full((x.shape[0],), cfg.n_layers, dtype=torch.int32,
                           device=x.device)
    return logits, depth


def _prefix_len(cfg: ModelConfig, prefix_embeds) -> int:
    """Stream positions a VLM request's patch prefix takes (0 without
    one)."""
    return cfg.n_patches if (cfg.family == "vlm"
                             and prefix_embeds is not None) else 0


def _prefill_audio(params, cfg, tokens, cache, frames, rows, mask,
                   rules=None, split=sh.WHOLE):
    """The audio family's one-shot prefill: the encoder over ``frames``,
    its cross K/V (returned fresh: a rank's K/V heads under ``split``),
    then the decoder in mode ``prefill``, writing the prompt's self K/V
    in place at ``rows``."""
    if frames is None:
        raise ValueError("the audio family's prefill needs frames "
                         f"(B, {cfg.n_frames}, {cfg.d_model})")
    cdt = cfg.dtype("compute")
    enc_out = encdec.encode(params, cfg, frames, split)
    cross = encdec.cross_kv(params, cfg, enc_out)
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens, split) + layers.sinusoidal_positions(
        S, cfg.d_model, cdt, tokens.device)
    node = cache["self"].ensure_private(rows, start=0, width=S, mask=mask)
    for i, lp in enumerate(transformer.layer_params(params["decoder"])):
        x = encdec._dec_block(lp, x, cfg, enc_out, mode="prefill",
                              self_kv=node.view(i, rows=rows, mask=mask),
                              split=split)
    return _logits_head(params, cfg, x, rules, split), {"cross": cross}


def prefill(params, cfg: ModelConfig, tokens, cache, *, rows=None,
            mask=None, prefix_embeds=None, frames=None, rules=None,
            split=sh.WHOLE):
    """Prime the cache with a full prompt (one-shot). A VLM's
    ``prefix_embeds`` (B, n_patches, d_model) go in front of the tokens;
    the audio family's encoder reads ``frames`` (B, n_frames, d_model).

    Returns ``(logits (B, S, padded_vocab), fresh)``. ``rows``/``mask``
    bind prompt row ``i`` to cache row ``rows[i]``: attention K/V is
    written in place at those rows, masked rows only. SSM state comes
    back FRESH and prompt-batch-wide in ``fresh = {"ssm": {"conv": (L, B,
    K-1, Di), "h": (L, B, Di, N)}}`` for the caller to splice along axis
    1 (``fresh`` is ``{}`` for the attention-decoder families). The
    hybrid runs its shared block in prefill mode at each application,
    writing cache layer ``a``, and returns its mamba2 state fresh; the
    audio family returns its cross K/V fresh, ``{"cross": {"k": (L, B,
    n_frames, KV, hd), "v": ...}}``. ``rules`` and ``split`` as in
    ``decode_step``."""
    if cfg.family == "audio":
        return _prefill_audio(params, cfg, tokens, cache, frames, rows,
                              mask, rules, split)
    x = _embed(params, cfg, tokens, split)
    if _prefix_len(cfg, prefix_embeds):
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None]
    lps = transformer.layer_params(params["layers"])
    if cfg.family in ("ssm", "hybrid"):
        convs, hs = [], []

        def mixers(x, layers_):
            for i in layers_:
                h = layers.apply_norm(cfg.norm, x, lps[i], "ln")
                y, st = ssm_lib.mixer_forward(lps[i]["ssm"], h, cfg,
                                              return_state=True, split=split)
                x = x + y
                convs.append(st["conv"])
                hs.append(st["h"])
            return x

        if cfg.family == "ssm":
            x = mixers(x, range(cfg.n_layers))
        else:
            node = cache["attn"].ensure_private(rows, start=0, width=S,
                                                mask=mask)
            for app, seg in enumerate(transformer.hybrid_segments(cfg)):
                x = transformer.attn_block(
                    params["shared_attn"], x, cfg, positions=positions,
                    mode="prefill",
                    kv_cache=node.view(app, rows=rows, mask=mask),
                    split=split)
                x = mixers(x, seg)
        fresh = {"ssm": {"conv": torch.stack(convs), "h": torch.stack(hs)}}
        return _logits_head(params, cfg, x, rules, split), fresh
    node = cache["attn"].ensure_private(rows, start=0, width=S, mask=mask)
    for i, lp in enumerate(lps):
        x = transformer.attn_block(
            lp, x, cfg, positions=positions, mode="prefill",
            kv_cache=node.view(i, rows=rows, mask=mask), split=split)
    return _logits_head(params, cfg, x, rules, split), {}


def prefill_chunk(params, cfg: ModelConfig, prompts, cache, offsets, *,
                  chunk: int, mask=None, prefix_embeds=None, rules=None,
                  split=sh.WHOLE):
    """Advance prefill by one ``chunk``-token slice of each row's prompt
    stream (a VLM's ``prefix_embeds`` (n, n_patches, d_model) at stream
    positions ``[0, n_patches)``, then the tokens).

    prompts: (n, W) int32, the full per-row token buffers (lanes past a
    row's true length are garbage, causally invisible to real queries);
    offsets: (n,) int32 per-row stream offsets; ``mask`` (n,) bool
    selects the rows that write. The audio family adds the sinusoid of
    each position and reads the cross K/V that a one-shot ``prefill``
    left in ``cache["cross"]``. Each row embeds positions
    ``[offsets[i], offsets[i] + chunk)``, writes their K/V at those
    offsets and attends causally against everything already written;
    through the block table (flash-prefill kernel) when
    ``cfg.attn_impl == "cuda"`` and the cache is paged.

    Returns logits (n, chunk, padded_vocab). ``rules`` and ``split`` as
    in ``decode_step``."""
    if cfg.family not in ATTN_FAMILIES + ("audio",):
        raise ValueError(
            f"chunked prefill requires an attention-family cache; family "
            f"{cfg.family!r} folds its recurrent state through a full-prompt "
            f"forward (use engine.prefill)")
    W = prompts.shape[1]
    pos = offsets.long()[:, None] + torch.arange(
        chunk, device=offsets.device)[None, :]
    prefix = _prefix_len(cfg, prefix_embeds)
    tid = torch.gather(prompts, 1, (pos - prefix).clamp(0, W - 1))
    x = _embed(params, cfg, tid, split)
    if prefix:
        # a patch embed where pos < prefix, a token embed elsewhere
        pe = torch.gather(prefix_embeds.to(x.dtype), 1,
                          pos.clamp(0, prefix - 1)[..., None].expand(
                              -1, -1, x.shape[-1]))
        x = torch.where((pos < prefix)[..., None], pe, x)
    node = cache[kv_key(cfg)].ensure_private(start=offsets, width=chunk,
                                             mask=mask)
    if cfg.family == "audio":
        x = x + layers.sinusoid_at(pos, cfg.d_model, x.dtype)
        cross = cache["cross"]
        for i, lp in enumerate(transformer.layer_params(params["decoder"])):
            x = encdec._dec_block(
                lp, x, cfg, mode="chunk", self_kv=node.view(i, mask=mask),
                cross_kv=kvc.CrossView(cross["k"][i], cross["v"][i]),
                chunk_off=offsets, split=split)
        return _logits_head(params, cfg, x, rules, split)
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.attn_block(
            lp, x, cfg, positions=pos, mode="chunk",
            kv_cache=node.view(i, mask=mask), chunk_off=offsets,
            split=split)
    return _logits_head(params, cfg, x, rules, split)


def verify_step(params, cfg: ModelConfig, tokens, cache, cur_len, *,
                write_mask=None, rules=None, split=sh.WHOLE):
    """Score a W-token speculative window in ONE forward.

    tokens: (B, W) int, ``[pending, d_1..d_{W-1}]`` per row; the window
    starts at ``cur_len - 1`` (the pending token's position), so position
    j's logits are the distribution over the token after the window's
    first j+1 tokens. Returns logits (B, W, padded_vocab); the cache is
    updated in place.

    The window's K/V goes through the chunked-prefill write path at
    per-row offsets (mode ``verify``: ``write_chunk``, then decode-exact
    ``verify_attention``), overwriting stale lanes of rejected drafts
    before a query can see them. ``write_mask`` gates rows as in
    ``decode_step``, and so do ``rules`` and ``split``. Attention-decoder
    families only."""
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"verify_step requires an attention-decoder "
                         f"family (dense/moe/vlm); got {cfg.family!r}")
    W = tokens.shape[1]
    off = cur_len - 1
    positions = off.long()[:, None] + torch.arange(
        W, device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens, split)
    # copy-on-write once per window, before any layer writes
    node = cache["attn"].ensure_private(start=off, width=W, mask=write_mask)
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.attn_block(
            lp, x, cfg, positions=positions, mode="verify",
            kv_cache=node.view(i, mask=write_mask), chunk_off=off,
            split=split)
    return _logits_head(params, cfg, x, rules, split)


# =========================== paths that ran =================================

def _kernel_path(cfg, kv_impl) -> bool:
    return cfg.attn_impl == "cuda" and kv_impl == "paged"


def resolved_attn_impl(cfg: ModelConfig, kv_impl: str, device,
                       verify: bool = False) -> str:
    """Which decode-attention path a (cfg, kv_impl, device) triple
    runs: "cuda-paged:sm_90a" (the paged-attention kernel on the card),
    "torch-plain-paged:cpu" (its plain version, for CPU tensors),
    "gather:dense" / "gather:paged", or "attention-free" (pure SSM: no
    K/V and no attention, whatever the knobs say). With ``verify`` (a
    speculative pool decodes through ``verify_step``) the kernel path is
    the chunk kernel's verify entry: "cuda-verify-paged:sm_90a" or
    "torch-plain-verify-paged:cpu"."""
    if kv_key(cfg) is None:
        return "attention-free"
    dev = torch.device(device)
    if _kernel_path(cfg, kv_impl):
        kind = "verify-paged:" if verify else "paged:"
        return ("cuda-" + kind + ARCH_TAG if dev.type == "cuda"
                else "torch-plain-" + kind + dev.type)
    return f"gather:{kv_impl}"


def resolved_prefill_impl(cfg: ModelConfig, kv_impl: str, prefill: str,
                          device) -> str:
    """Which prefill-attention path runs: "dense-bucketed" (one-shot:
    one forward over the right-padded, bucketed prompt), or for chunked
    prefill "cuda-flash-paged:sm_90a" (the flash-prefill kernel),
    "torch-plain-flash-paged:cpu" (its plain version) or
    "gather-chunked"; "attention-free" for pure SSM."""
    if kv_key(cfg) is None:
        return "attention-free"
    if prefill != "chunked":
        return "dense-bucketed"
    dev = torch.device(device)
    if _kernel_path(cfg, kv_impl):
        return ("cuda-flash-paged:" + ARCH_TAG if dev.type == "cuda"
                else "torch-plain-flash-paged:" + dev.type)
    return "gather-chunked"


# =========================== batch-synchronous loop ==========================

@dataclasses.dataclass
class GenerateResult:
    """Per-request generation output. ``lengths`` counts the EOS token;
    ``text_lengths`` counts the tokens before it; a row that never hit
    EOS has both equal to ``max_new``. ``attn_impl``/``prefill_impl``
    name the paths that ran."""

    tokens: torch.Tensor        # (B, max_new)
    lengths: torch.Tensor       # (B,)
    steps: int                  # loop iterations run
    text_lengths: torch.Tensor  # (B,)
    attn_impl: str = ""
    prefill_impl: str = ""


def _result_from_tokens(toks, eos_id, steps, attn_impl="",
                        prefill_impl="") -> GenerateResult:
    is_eos = toks == eos_id
    has_eos = is_eos.any(dim=1)
    first_eos = torch.argmax(is_eos.int(), dim=1)
    lengths = torch.where(has_eos, first_eos + 1, toks.shape[1])
    return GenerateResult(tokens=toks, lengths=lengths, steps=steps,
                          text_lengths=lengths - has_eos.long(),
                          attn_impl=attn_impl, prefill_impl=prefill_impl)


def generate_batch_sync(params, cfg: ModelConfig, prompt, *, max_new: int,
                        eos_id: int = 1, kv_impl: str = "dense",
                        kv_block: int = 16, prefix_embeds=None,
                        frames=None) -> GenerateResult:
    """Greedy decode with per-sequence EOS early exit, batch-synchronous.

    The JAX package runs this loop in-graph (``core.while_loop``). Here
    it is a Python loop over a preallocated output tensor with one host
    read of ``done.all()`` per step: the data-dependent exit is the only
    value the host needs. prompt: (B, S) int on the device to run on;
    ``prefix_embeds`` (B, n_patches, d_model): a VLM's patch prefix;
    ``frames`` (B, n_frames, d_model): the audio family's encoder
    input."""
    B, S = prompt.shape
    dev = prompt.device
    prefix = _prefix_len(cfg, prefix_embeds)
    max_len = S + prefix + max_new + 1
    cache = make_cache(cfg, B, max_len, kv_impl=kv_impl, kv_block=kv_block,
                       device=dev)
    if kv_key(cfg) is not None:
        cache[kv_key(cfg)].alloc(torch.arange(B, device=dev),
                                 torch.full((B,), max_len, device=dev))
    sp = sampling_lib.SamplingParams()
    logits, fresh = prefill(params, cfg, prompt, cache,
                            prefix_embeds=prefix_embeds, frames=frames)
    cache.update(fresh)
    token = sampling_lib.sample_slots(logits[:, -1], None, sp)[:, None]
    out = torch.zeros((max_new, B), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    cur, i = S + prefix + 1, 0
    while i < max_new and not bool(done.all()):
        out[i] = torch.where(done, eos_id, token[:, 0])
        done = done | (token[:, 0] == eos_id)
        # rows done at EOS start the adaptive layer loop halted
        logits = decode_step(params, cfg, token, cache, cur,
                             live=~done if cfg.early_exit else None)
        token = sampling_lib.sample_slots(logits[:, -1], None, sp)[:, None]
        i, cur = i + 1, cur + 1
    return _result_from_tokens(
        out.T, eos_id, i, attn_impl=resolved_attn_impl(cfg, kv_impl, dev),
        prefill_impl=resolved_prefill_impl(cfg, kv_impl, "oneshot", dev))
