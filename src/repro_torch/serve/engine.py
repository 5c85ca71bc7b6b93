"""Serving engine, dense and pure-SSM families: caches, prefill,
chunked prefill, single-token decode, the speculative verify window, and
the batch-synchronous generation loop.

Port of ``repro/serve/engine.py``. Self-attention K/V lives behind the
``serve.kv_cache`` API: ``make_cache`` builds ``{"attn": KVCache}`` and
every layer reads and writes its slice through a view, so the dense and
paged layouts share every line of attention math. A pure-SSM model's
cache is ``{"ssm": {"conv", "h"}}``: plain per-row state with the layer
dim first and the batch dim at axis 1 of every leaf, the invariant the
scheduler's admission splice relies on. The caches are updated in
place, so the decode and chunk steps return logits only; ``prefill``
also returns the SSM state it computed, fresh, for the caller to splice.

``decode_step`` accepts an int ``cur_len`` (whole batch in lockstep) or
a per-row ``(B,)`` int32 tensor (slot pool at mixed depths).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..configs import ModelConfig, require_ported
from ..kernels import ARCH_TAG
from ..models import layers, ssm as ssm_lib, transformer
from . import kv_cache as kvc
from . import sampling as sampling_lib


def _ssm_struct(cfg: ModelConfig, batch: int, device) -> Dict[str, Any]:
    """Zeroed mamba1 state: conv (L, batch, K-1, Di) in the compute
    dtype, h (L, batch, Di, N) fp32."""
    s, L, di = cfg.ssm, cfg.n_layers, cfg.d_inner
    return {"conv": torch.zeros((L, batch, s.d_conv - 1, di),
                                dtype=cfg.dtype("compute"), device=device),
            "h": torch.zeros((L, batch, di, s.d_state), dtype=torch.float32,
                             device=device)}


def kv_key(cfg: ModelConfig) -> Optional[str]:
    """Cache-dict key of the family's self-attention ``KVCache`` (None
    for pure-SSM families, which have no attention K/V)."""
    return {"dense": "attn", "ssm": None}[cfg.family]


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               kv_impl: str = "dense", kv_block: int = 16,
               kv_blocks: Optional[int] = None,
               device="cuda") -> Dict[str, Any]:
    """``{"attn": KVCache}`` for the dense family, ``{"ssm": {"conv",
    "h"}}`` for pure SSM. ``kv_impl`` selects the K/V layout ("dense" |
    "paged"), ``kv_block``/``kv_blocks`` size the paged pool
    (``kv_blocks=None``: dense-equivalent capacity)."""
    require_ported(cfg)
    if cfg.family == "ssm":
        return {"ssm": _ssm_struct(cfg, batch, resolve_device(device))}
    return {"attn": kvc.make_kv_cache(cfg, cfg.n_layers, batch, max_len,
                                      impl=kv_impl, block=kv_block,
                                      n_blocks=kv_blocks, device=device)}


def _logits_head(params, cfg: ModelConfig, x):
    """Final norm + (tied / untied) unembed."""
    x = layers.apply_norm(cfg.norm, x, params, "ln_final")
    return x.to(cfg.dtype("compute")) @ transformer.unembed_weight(params,
                                                                   cfg)


def _decode_positions(cur_len, device):
    """(1, 1) positions for an int ``cur_len``; (B, 1) for a tensor."""
    if torch.is_tensor(cur_len):
        return (cur_len.long() - 1)[:, None]
    return torch.full((1, 1), int(cur_len) - 1, dtype=torch.long,
                      device=device)


def _decode_attn_families(params, cfg, x, cache, cur_len, write_mask):
    """The layer loop of a decode step (the static-depth path of the
    JAX package's ``transformer.decode_layers``, as a Python loop)."""
    positions = _decode_positions(cur_len, x.device)
    start = (cur_len - 1) if torch.is_tensor(cur_len) else int(cur_len) - 1
    node = cache["attn"].ensure_private(start=start, width=1,
                                        mask=write_mask)
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.attn_block(
            lp, x, cfg, positions=positions, mode="decode",
            kv_cache=node.view(i, mask=write_mask), cur_len=cur_len)
    return x


def _decode_ssm(params, cfg, x, cache):
    """The layer loop of a pure-SSM decode step; each layer updates its
    slice of the cache's conv and h state in place."""
    st = cache["ssm"]
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.ssm_block(lp, x, cfg, mode="decode",
                                  state={"conv": st["conv"][i],
                                         "h": st["h"][i]})
    return x


def decode_step(params, cfg: ModelConfig, token, cache, cur_len, *,
                write_mask=None):
    """One new token against a cache of ``cur_len - 1`` positions.

    token: (B, 1) int. Returns logits (B, 1, padded_vocab); the cache is
    updated in place. ``write_mask`` (B,) bool (attention families only)
    gates which rows' K/V append lands: the chunked-prefill scheduler
    decodes the whole pool while some slots are mid-prefill, whose stale
    ``cur_len`` points into their own prompt."""
    if write_mask is not None and cfg.family != "dense":
        raise ValueError(f"write_mask is only supported for attention "
                         f"families; got family {cfg.family!r}")
    x = params["embed"][token]
    if cfg.family == "ssm":
        x = _decode_ssm(params, cfg, x, cache)
    else:
        x = _decode_attn_families(params, cfg, x, cache, cur_len,
                                  write_mask)
    return _logits_head(params, cfg, x)


def prefill(params, cfg: ModelConfig, tokens, cache, *, rows=None,
            mask=None):
    """Prime the cache with a full prompt (one-shot).

    Returns ``(logits (B, S, padded_vocab), fresh)``. ``rows``/``mask``
    bind prompt row ``i`` to cache row ``rows[i]``: attention K/V is
    written in place at those rows, masked rows only. SSM state comes
    back FRESH and prompt-batch-wide in ``fresh = {"ssm": {"conv": (L, B,
    K-1, Di), "h": (L, B, Di, N)}}`` for the caller to splice along axis
    1 (``fresh`` is ``{}`` for the dense family)."""
    x = params["embed"][tokens]
    if cfg.family == "ssm":
        convs, hs = [], []
        for lp in transformer.layer_params(params["layers"]):
            h = layers.apply_norm(cfg.norm, x, lp, "ln")
            y, st = ssm_lib.mamba1_forward(lp["ssm"], h, cfg,
                                           return_state=True)
            x = x + y
            convs.append(st["conv"])
            hs.append(st["h"])
        fresh = {"ssm": {"conv": torch.stack(convs), "h": torch.stack(hs)}}
        return _logits_head(params, cfg, x), fresh
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None]
    node = cache["attn"].ensure_private(rows, start=0, width=S, mask=mask)
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.attn_block(
            lp, x, cfg, positions=positions, mode="prefill",
            kv_cache=node.view(i, rows=rows, mask=mask))
    return _logits_head(params, cfg, x), {}


def prefill_chunk(params, cfg: ModelConfig, prompts, cache, offsets, *,
                  chunk: int, mask=None):
    """Advance prefill by one ``chunk``-token slice of each row's prompt.

    prompts: (n, W) int32, the full per-row token buffers (lanes past a
    row's true length are garbage, causally invisible to real queries);
    offsets: (n,) int32 per-row stream offsets; ``mask`` (n,) bool
    selects the rows that write. Each row embeds positions
    ``[offsets[i], offsets[i] + chunk)``, writes their K/V at those
    offsets and attends causally against everything already written;
    through the block table (flash-prefill kernel) when
    ``cfg.attn_impl == "cuda"`` and the cache is paged.

    Returns logits (n, chunk, padded_vocab)."""
    W = prompts.shape[1]
    pos = offsets.long()[:, None] + torch.arange(
        chunk, device=offsets.device)[None, :]
    tid = torch.gather(prompts, 1, pos.clamp(0, W - 1))
    x = params["embed"][tid]
    node = cache["attn"].ensure_private(start=offsets, width=chunk,
                                        mask=mask)
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.attn_block(
            lp, x, cfg, positions=pos, mode="chunk",
            kv_cache=node.view(i, mask=mask), chunk_off=offsets)
    return _logits_head(params, cfg, x)


def verify_step(params, cfg: ModelConfig, tokens, cache, cur_len, *,
                write_mask=None):
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
    ``decode_step``. Attention-decoder families only."""
    if cfg.family != "dense":
        raise ValueError(f"verify_step requires an attention-decoder "
                         f"family (dense); got {cfg.family!r}")
    W = tokens.shape[1]
    off = cur_len - 1
    positions = off.long()[:, None] + torch.arange(
        W, device=tokens.device)[None, :]
    x = params["embed"][tokens]
    # copy-on-write once per window, before any layer writes
    node = cache["attn"].ensure_private(start=off, width=W, mask=write_mask)
    for i, lp in enumerate(transformer.layer_params(params["layers"])):
        x = transformer.attn_block(
            lp, x, cfg, positions=positions, mode="verify",
            kv_cache=node.view(i, mask=write_mask), chunk_off=off)
    return _logits_head(params, cfg, x)


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
                        kv_block: int = 16) -> GenerateResult:
    """Greedy decode with per-sequence EOS early exit, batch-synchronous.

    The JAX package runs this loop in-graph (``core.while_loop``). Here
    it is a Python loop over a preallocated output tensor with one host
    read of ``done.all()`` per step: the data-dependent exit is the only
    value the host needs. prompt: (B, S) int on the device to run on."""
    B, S = prompt.shape
    dev = prompt.device
    max_len = S + max_new + 1
    cache = make_cache(cfg, B, max_len, kv_impl=kv_impl, kv_block=kv_block,
                       device=dev)
    if kv_key(cfg) is not None:
        cache[kv_key(cfg)].alloc(torch.arange(B, device=dev),
                                 torch.full((B,), max_len, device=dev))
    sp = sampling_lib.SamplingParams()
    logits, fresh = prefill(params, cfg, prompt, cache)
    cache.update(fresh)
    token = sampling_lib.sample_slots(logits[:, -1], None, sp)[:, None]
    out = torch.zeros((max_new, B), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    cur, i = S + 1, 0
    while i < max_new and not bool(done.all()):
        out[i] = torch.where(done, eos_id, token[:, 0])
        done = done | (token[:, 0] == eos_id)
        logits = decode_step(params, cfg, token, cache, cur)
        token = sampling_lib.sample_slots(logits[:, -1], None, sp)[:, None]
        i, cur = i + 1, cur + 1
    return _result_from_tokens(
        out.T, eos_id, i, attn_impl=resolved_attn_impl(cfg, kv_impl, dev),
        prefill_impl=resolved_prefill_impl(cfg, kv_impl, "oneshot", dev))
