"""Decoder-only LM, dense, MoE, VLM, pure-SSM and hybrid families:
parameters, the attention block and its modes, the mamba block, and the
full-sequence forward.

Port of ``repro/models/transformer.py`` (``attn_params``,
``mlp_params``, ``_attn_block_params``, ``_ssm_block_params``,
``build_params``, ``attn_apply``, ``attn_block``, ``ssm_block``,
``_hybrid_layers``, ``forward_features``, ``forward``). The stacked layer
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

The MoE family's block replaces the SwiGLU MLP by ``moe.moe_mlp``
(``attn_block(..., with_aux=True)`` also returns its auxiliary losses,
which ``forward_features`` sums over the layers);
the VLM family prepends ``prefix_embeds``, the patch embeddings, to the
token embeddings. The hybrid family (zamba2) stacks mamba2 blocks and
holds ONE ``shared_attn`` block (attention and SwiGLU MLP), applied
before every ``shared_attn_every``-th segment of mamba2 layers.

The decode step's layer loop with adaptive depth (``models.adaptive``:
early exit, mixture-of-depths) is ``decode_layers``, with
``kv_project_append`` filling the K/V of the layers a row skips; the
full-sequence forward applies mixture-of-depths at routed layers.

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
from ..core import device_loop
from ..dist import sharding as sh
from ..kernels import ARCH_TAG
from . import adaptive
from . import attention as attn_lib
from . import layers
from . import moe as moe_lib
from . import ssm as ssm_lib


# =========================== parameters ====================================
# Structure functions over a parameter source ``b`` whose ``b.p(shape,
# axes, init=..., scale=..., fan_in=...)`` draws one tensor (or, in its
# axes mode, returns the logical axes)
# (``bridge.init_params``), as the JAX package's ``build_params`` runs
# over the parameter factory of its ``models/params.py``.

def attn_params(b, cfg, d_model: int):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # fan_in=d_model: the JAX package's default (shape[-2], the head
    # count here) makes random full-width attention an argmax
    # (bridge.init_params)
    p = {"wq": b.p((d_model, H, hd), (sh.EMBED, sh.HEADS, sh.HEAD_DIM),
                   fan_in=d_model),
         "wk": b.p((d_model, KV, hd), (sh.EMBED, sh.KV_HEADS, sh.HEAD_DIM),
                   fan_in=d_model),
         "wv": b.p((d_model, KV, hd), (sh.EMBED, sh.KV_HEADS, sh.HEAD_DIM),
                   fan_in=d_model),
         "wo": b.p((H, hd, d_model), (sh.HEADS, sh.HEAD_DIM, sh.EMBED),
                   fan_in=H * hd)}
    if cfg.qkv_bias:
        p["bq"] = b.p((H, hd), (sh.HEADS, sh.HEAD_DIM), init="zeros")
        p["bk"] = b.p((KV, hd), (sh.KV_HEADS, sh.HEAD_DIM), init="zeros")
        p["bv"] = b.p((KV, hd), (sh.KV_HEADS, sh.HEAD_DIM), init="zeros")
    return p


def mlp_params(b, cfg, d_model: int, d_ff: int):
    return {"w_gate": b.p((d_model, d_ff), (sh.EMBED, sh.MLP)),
            "w_up": b.p((d_model, d_ff), (sh.EMBED, sh.MLP)),
            "w_down": b.p((d_ff, d_model), (sh.MLP, sh.EMBED), fan_in=d_ff)}


def norm_params(b, kind: str, d: int, name: str):
    """A norm's parameters: ``name`` (ones) for rmsnorm, ``name`` and
    its bias ``name + "_b"`` (zeros) for layernorm, none for OLMo's
    non-parametric norm; drawn in the param dtype, which the norms read
    them in."""
    if kind == "rmsnorm":
        return {name: b.p((d,), (sh.EMBED,), init="ones")}
    if kind == "layernorm":
        return {name: b.p((d,), (sh.EMBED,), init="ones"),
                name + "_b": b.p((d,), (sh.EMBED,), init="zeros",
                                 param_dtype=True)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(kind)


class _Stacked:
    """Wrap a parameter source so every param gains a leading
    (layers,) dim."""

    def __init__(self, b, n: int):
        self._b, self._n = b, n

    def p(self, shape, axes, **kw):
        return self._b.p((self._n, *shape), (sh.LAYERS, *axes), **kw)


def _attn_block_params(b, cfg):
    D = cfg.d_model
    p = {**norm_params(b, cfg.norm, D, "ln_attn"),
         "attn": attn_params(b, cfg, D),
         **norm_params(b, cfg.norm, D, "ln_mlp")}
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_params(b, cfg, D)
    else:
        p["mlp"] = mlp_params(b, cfg, D, cfg.d_ff)
    if adaptive.mod_on(cfg):
        p["router"] = adaptive.router_params(b, cfg)
    return p


def _ssm_block_params(b, cfg):
    mixer = (ssm_lib.mamba1_params if cfg.ssm.kind == "mamba1"
             else ssm_lib.mamba2_params)
    return {**norm_params(b, cfg.norm, cfg.d_model, "ln"),
            "ssm": mixer(b, cfg)}


def build_params(cfg, b):
    """The dense, MoE, VLM, pure-SSM or hybrid family's parameter tree
    (the JAX package's names and layouts; layer leaves stacked on a
    leading L dim; the hybrid's one ``shared_attn`` block unstacked)."""
    D = cfg.d_model
    lb = _Stacked(b, cfg.n_layers)
    shared = {}
    if cfg.family in ("ssm", "hybrid"):
        layers_p = _ssm_block_params(lb, cfg)
        if cfg.family == "hybrid":
            shared["shared_attn"] = _attn_block_params(b, cfg)
    else:
        layers_p = _attn_block_params(lb, cfg)
    p = {"embed": b.p((cfg.padded_vocab, D), (sh.VOCAB, sh.EMBED),
                      init="normal", scale=0.02),
         "layers": layers_p, **shared,
         **norm_params(b, cfg.norm, D, "ln_final")}
    if not cfg.tie_embeddings:
        p["unembed"] = b.p((D, cfg.padded_vocab), (sh.EMBED, sh.VOCAB),
                           init="normal",
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


def head_range(p, cfg, split=sh.WHOLE):
    """``(q_head0, n_heads)`` of an attention sublayer's weights ``p`` as
    a rank holds them: where ``HEADS`` splits the query heads over the
    model axis and ``KV_HEADS`` leaves the K/V heads whole (GQA whose K/V
    heads do not divide the axis), the rank's H/m query heads are the
    whole model's ``[q_head0, q_head0 + H/m)`` against every K/V head;
    elsewhere the rank's query and K/V heads form whole groups, ``(0,
    H)``."""
    H, KV = p["wq"].shape[-2], p["wk"].shape[-2]
    if H == cfg.n_heads or KV < cfg.n_kv_heads:
        return 0, H
    return split.offset(H, cfg.n_heads), cfg.n_heads


def attn_apply(p, x, cfg, *, positions, mode: str = "full",
               kv_cache=None, cur_len=None, chunk_off=None,
               split=sh.WHOLE):
    """One attention sublayer; returns its output (B, S, d_model) in
    x's dtype. ``kv_cache`` is a cache layer view (``serve.kv_cache``)
    in the prefill, chunk, verify and decode modes.

    The head counts are the weights': on a rank's slices of a serving
    mesh's model axis (``split``) it attends on its query heads against
    its K/V heads (``head_range``), and its output projection, a part of
    the sum over every head, is summed over the model axis."""
    cdt = cfg.dtype("compute")
    xc = x.to(cdt)
    B, S, D = xc.shape
    H, KV, hd = p["wq"].shape[-2], p["wk"].shape[-2], cfg.resolved_head_dim
    q0, n_heads = head_range(p, cfg, split)
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
        out = sh.local_heads(lambda q, k, v: attn_lib.chunked_attention(
            q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
            k_chunk=cfg.attn_k_chunk,
            skip_masked_blocks=cfg.attn_skip_masked_blocks),
            q, *attn_lib.heads_kv(k, v, H, q0, n_heads))
    elif mode == "chunk":
        kv_cache.write_chunk(k, v, chunk_off)
        out = attn_lib.prefill_attention(q, kv_cache, q_off=chunk_off,
                                         attn_impl=cfg.attn_impl,
                                         k_chunk=cfg.attn_k_chunk,
                                         q_head0=q0, n_heads=n_heads)
    elif mode == "verify":
        kv_cache.write_chunk(k, v, chunk_off)
        out = attn_lib.verify_attention(q, kv_cache, q_off=chunk_off,
                                        attn_impl=cfg.attn_impl,
                                        q_head0=q0, n_heads=n_heads)
    elif mode == "decode":
        kv_cache.append(k, v, cur_len)
        out = attn_lib.decode_attention(q, kv_cache, cur_len=cur_len,
                                        attn_impl=cfg.attn_impl,
                                        q_head0=q0, n_heads=n_heads)
    else:
        raise ValueError(mode)
    out = out.to(cdt).reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    out = split.sum_parts(out, H < cfg.n_heads)
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
               cur_len=None, chunk_off=None, with_aux: bool = False,
               split=sh.WHOLE):
    """Pre-norm attention + (MoE | SwiGLU MLP) block; returns the new x,
    or ``(x, aux)`` with ``with_aux`` (the MoE auxiliary losses; ``{}``
    for the other families). On a rank's slices of a serving mesh's
    model axis (``split``) each sublayer's part is summed over the axis:
    the attention's after ``wo``, the MLP's after ``w_down`` where
    ``MLP`` splits its hidden width, the MoE's after its experts."""
    h = layers.apply_norm(cfg.norm, x, p, "ln_attn")
    a = attn_apply(p["attn"], h, cfg, positions=positions, mode=mode,
                   kv_cache=kv_cache, cur_len=cur_len, chunk_off=chunk_off,
                   split=split)
    if cfg.remat == "attn_out":   # only there: other modes' graphs unchanged
        a = tag_attn_out(a)
    x = x + sh.keep_grad_layout(a)
    h = layers.apply_norm(cfg.norm, x, p, "ln_mlp")
    aux: Dict[str, torch.Tensor] = {}
    if cfg.family == "moe":
        m, aux = moe_lib.moe_mlp(p["moe"], h, cfg, need_aux=with_aux,
                                 split=split)
    else:
        m = layers.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                          p["mlp"]["w_down"], cfg.dtype("compute"))
        m = split.sum_parts(m, p["mlp"]["w_down"].shape[-2] < cfg.d_ff)
    x = x + sh.keep_grad_layout(m.to(x.dtype))
    return (x, aux) if with_aux else x


def kv_project_append(p, h, cfg, kv_cache, positions, cur_len) -> None:
    """K/V projection and cache append only: ``attn_apply``'s decode
    write path without q, attention or the output projection. The
    skipped-layer K/V fill of early-exit decode: a row that halted at
    layer ``e`` still owes the cache K/V for layers ``e..L-1``. The ops
    mirror ``attn_apply``'s line for line, so a layer filled from ``h``
    holds the same bits as one whose block ran on the same ``h``, which
    must already be this layer's ``ln_attn`` output."""
    cdt = cfg.dtype("compute")
    xc = h.to(cdt)
    B, S, D = xc.shape
    KV, hd = p["wk"].shape[-2], cfg.resolved_head_dim
    k = (xc @ p["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = (xc @ p["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = layers.rope(k, positions, cfg.rope_theta)
    kv_cache.append(k, v, cur_len)


def decode_layers(lps, x, cfg, *, block_fn, halt_fn=None, kv_fill_fn=None,
                  live=None):
    """Drive the decode-mode layer stack (one token a row).

    ``lps``: the per-layer parameter views (``layer_params``).
    ``block_fn(lp, x, i) -> (x_new, applied)`` runs decoder block ``i``
    and always performs its K/V append (a row whose output is masked
    off still writes K/V projected from its frozen hidden state);
    ``applied`` (B,) bool says which rows' residual stream advanced
    (mixture-of-depths skips report False), None meaning every row.

    ``halt_fn`` None: depth is static, a Python loop over the layers.
    Otherwise ``halt_fn(x, i) -> (B,) bool`` marks rows allowed to halt
    after layer ``i``: the loop runs while any row is live, ``halted |=
    halt_fn(x, i)`` (a halted row never un-halts), halted rows carry
    ``x`` through (their block still runs, K/V included, but its output
    is discarded), and after the loop ``kv_fill_fn(lp, x, i)`` (K/V
    projection only, no attention) fills layers ``i_exit..L-1`` for
    every row. ``live`` (B,) bool: rows that keep the loop alive
    (retired slots pass False and start halted); ignored when static.

    Two lowerings of the adaptive loop. Eagerly (the CPU, and the
    card's host-read segment) it is ``core.while_loop`` with a Python
    layer counter: the vector predicate ``~halted`` is read once a layer
    (``while_loop.host_reads``), and the fill is a second loop from the
    exit counter. Inside a body that ``core.device_loop`` captures, each
    layer sits behind an IF node on ``any(~halted)`` and each fill layer
    ``j`` behind one on ``i_exit <= j`` (``cond(backend="graph")``): the
    layers stay unrolled, so each reads its own weights as a view and
    ``node.view(i)`` keeps a Python layer, and the halt vector is
    monotone, so once the IF of layer ``k`` is false every later one is
    too. ``depth_impl`` names the lowering.

    Returns ``(x, depth)``: depth (B,) int32 counts the blocks applied
    a row. The input ``x`` is not written."""
    n, B, dev = len(lps), x.shape[0], x.device
    if halt_fn is None:
        depth = torch.zeros((B,), dtype=torch.int32, device=dev)
        for i, lp in enumerate(lps):
            x, applied = block_fn(lp, x, i)
            depth += 1 if applied is None else applied.int()
        return x, depth
    if kv_fill_fn is None:
        raise ValueError("decode_layers: halt_fn requires kv_fill_fn "
                         "(skipped-layer KV propagation)")
    # the loop state, written in place by each layer that runs
    x = x.clone()
    halted = (torch.zeros((B,), dtype=torch.bool, device=dev)
              if live is None else ~live)
    depth = torch.zeros((B,), dtype=torch.int32, device=dev)

    def layer(i):
        x_new, applied = block_fn(lps[i], x, i)
        run = ~halted if applied is None else applied & ~halted
        x.copy_(torch.where(run[:, None, None], x_new, x))
        depth.add_(run.int())
        halted.logical_or_(halt_fn(x, i))

    if device_loop.capturing():
        i_exit = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(n):
            def run_layer(i=i):
                layer(i)
                i_exit.fill_(i + 1)
            core.cond((~halted).any(), run_layer, _no_layer,
                      backend="graph")
        for j in range(n):
            core.cond(i_exit <= j,
                      lambda j=j: kv_fill_fn(lps[j], x, j), _no_layer,
                      backend="graph")
        return x, depth

    def body(i):
        layer(i)
        return i + 1

    i_exit = core.while_loop(lambda i: ~halted, body, 0, max_iters=n,
                             name="adaptive_layers")

    def fill(j):
        kv_fill_fn(lps[j], x, j)
        return j + 1

    core.while_loop(lambda j: j < n, fill, i_exit, max_iters=n,
                    name="kv_fill")
    return x, depth


def depth_impl(cfg, graph: bool) -> str:
    """Which lowering runs the decode layer loop: "static" (no early
    exit: a Python loop), "cuda-graph:if-per-layer" (inside a captured
    segment) or "host-read" (a predicate read a layer)."""
    if not cfg.early_exit:
        return "static"
    return "cuda-graph:if-per-layer" if graph else "host-read"


def _no_layer() -> None:
    """The untaken side of a layer's IF node: the state is in place."""


def ssm_block(p, x, cfg, *, mode="full", state=None, split=sh.WHOLE):
    """Pre-norm mamba block (mamba1 or mamba2 by ``cfg.ssm.kind``);
    returns the new x. Mode ``full`` runs the mixer over the sequence;
    mode ``decode`` takes one token (x: (B, 1, D)) and updates this
    layer's ``state`` (``{"conv", "h"}`` views into the cache) in
    place. On a rank's slices of a serving mesh's model axis
    (``split``) the mixer runs on its channels and its output is summed
    over the axis (``models.ssm``)."""
    h = layers.apply_norm(cfg.norm, x, p, "ln")
    if mode == "full":
        y = ssm_lib.mixer_forward(p["ssm"], h, cfg, split=split)
    elif mode == "decode":
        y, new = ssm_lib.mixer_step(p["ssm"], h[:, 0], state, cfg, split)
        state["conv"].copy_(new["conv"])
        state["h"].copy_(new["h"])
        y = y[:, None]
    else:
        raise ValueError(mode)
    return x + y


def unembed_weight(params, cfg):
    """The output projection (d_model, padded_vocab): the tied embedding
    (always, for the audio family, whose tree has no ``unembed``) or
    ``unembed``."""
    if cfg.tie_embeddings or cfg.family == "audio":
        return params["embed"].T
    return params["unembed"]


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
    """Wrap one layer step ``fn(lp, carry, i) -> carry`` per
    ``cfg.remat``."""
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
    ``block_fn(lp, x, i) -> x`` runs layer ``i`` (a Python int). The
    carry ``x`` may be a tuple (the MoE family carries its auxiliary
    losses beside the residual stream)."""
    step = _remat(block_fn, cfg)
    lps = layer_params(stacked)
    if cfg.layer_loop in ("scan", "unroll"):
        for i, lp in enumerate(lps):
            x = step(lp, x, i)
        return x
    if cfg.layer_loop == "paper_while":
        return core.fori_loop(0, len(lps),
                              lambda i, xx: step(lps[i], xx, i),
                              x, save_policy=cfg.save_policy)
    raise ValueError(cfg.layer_loop)


def layer_slice(stacked, start: int, stop: int):
    """The stacked layer tree's layers ``[start, stop)`` (views)."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, start, stop) for k, v in stacked.items()}
    return stacked[start:stop]


def hybrid_segments(cfg) -> List[range]:
    """The hybrid's mamba2 layers by shared-block application: app ``a``
    runs the shared block, then the layers of ``segments[a]``."""
    k, L = cfg.shared_attn_every, cfg.n_layers
    return [range(s, min(s + k, L)) for s in range(0, L, k)]


def _hybrid_layers(params, x, cfg, positions):
    """zamba2: the shared attention block before every segment of
    ``shared_attn_every`` mamba2 layers, each segment driven per
    ``cfg.layer_loop`` (the shared block outside the remat, as in the
    JAX package)."""
    for seg in hybrid_segments(cfg):
        x = attn_block(params["shared_attn"], x, cfg, positions=positions,
                       mode="full")
        x = _run_layers(layer_slice(params["layers"], seg.start, seg.stop),
                        x, cfg,
                        lambda lp, xx, i: ssm_block(lp, xx, cfg,
                                                    mode="full"))
    return x


def forward_features(params, cfg, tokens, *, prefix_embeds=None):
    """Backbone + final norm, no unembed. tokens: (B, S) int; the table
    is cast at this use (a no-op on serving weights, already cast).
    ``prefix_embeds`` (B, P, D): a VLM's patch embeddings, in front of
    the tokens. Returns ``(features, aux)``: aux is the MoE family's
    auxiliary losses summed over the layers (``{}`` otherwise).
    Mixture-of-depths applies at routed layers of every attention
    family, the MoE one included (the JAX package's one ``block_fn``)."""
    cdt = cfg.dtype("compute")
    x = params["embed"].to(cdt)[tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cdt), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    aux: Dict[str, torch.Tensor] = {}

    def routed(lp, xx, x2, i):
        if adaptive.mod_on(cfg):
            # the router weight scales the kept delta: differentiable
            return adaptive.mod_apply_full(lp["router"], xx, x2, i, cfg)
        return x2

    if cfg.family == "hybrid":
        x = _hybrid_layers(params, x, cfg, positions)
    elif cfg.family == "ssm":
        x = _run_layers(params["layers"], x, cfg,
                        lambda lp, xx, i: ssm_block(lp, xx, cfg,
                                                    mode="full"))
    elif cfg.family == "moe":
        def block_fn(lp, carry, i):
            xx, a = carry
            x2, d = attn_block(lp, xx, cfg, positions=positions,
                               mode="full", with_aux=True)
            return routed(lp, xx, x2, i), {k: a[k] + d[k] for k in a}
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = _run_layers(params["layers"], (x, {
            "moe_load_balance": zero, "moe_z_loss": zero}), cfg, block_fn)
    else:
        def block_fn(lp, xx, i):
            x2 = attn_block(lp, xx, cfg, positions=positions, mode="full")
            return routed(lp, xx, x2, i)
        x = _run_layers(params["layers"], x, cfg, block_fn)
    x = layers.apply_norm(cfg.norm, x, params, "ln_final")
    return x, aux


def forward(params, cfg, tokens, *, prefix_embeds=None):
    """``(logits, aux)``: full-sequence logits (B, S, padded_vocab) (S
    counts a VLM's patch prefix) and ``forward_features``' aux."""
    x, aux = forward_features(params, cfg, tokens,
                              prefix_embeds=prefix_embeds)
    cdt = cfg.dtype("compute")
    logits = x.to(cdt) @ unembed_weight(params, cfg).to(cdt)
    return logits, aux
