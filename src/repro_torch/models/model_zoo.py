"""Unified model entry for every family: the parameter builder,
forward, features, the loss and the parameter count.

Port of ``repro/models/model_zoo.py`` (``build_fn``, ``forward``,
``features``, ``cross_entropy``, ``_chunked_ce``, ``loss_fn``,
``count_params``, ``count_active_params``) for the dense, MoE, VLM,
pure-SSM, hybrid and audio families. ``batch`` is a dict of tensors:
``tokens`` (B, S), for a VLM ``patches`` (B, n_patches, d_model), the
patch embeddings in front of the tokens, for the audio family
``frames`` (B, n_frames, d_model), the stub frontend's frame
embeddings that the encoder reads, and for the loss ``labels`` (B, S);
labels outside ``[0, vocab)`` are masked. The loss adds the MoE
auxiliary terms with ``MOE_AUX_WEIGHTS``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import ModelConfig, require_ported
from ..dist import sharding as sh
from . import encdec, ssm, transformer

CE_CHUNK = 512
MOE_AUX_WEIGHTS = {"moe_load_balance": 1e-2, "moe_z_loss": 1e-3}


def build_fn(cfg: ModelConfig):
    """The family's parameter builder, ``fn(cfg, b)`` over a parameter
    source ``b`` (``bridge.init_params``)."""
    return (encdec.build_params if cfg.family == "audio"
            else transformer.build_params)


def _prefix(cfg: ModelConfig, batch: Dict):
    return batch.get("patches") if cfg.family == "vlm" else None


def forward(params, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor,
                                                            Dict]:
    """Full-sequence logits (B, S, padded_vocab) (a VLM's S counts its
    patches) and the aux dict (the MoE losses; empty otherwise)."""
    require_ported(cfg)
    if cfg.family == "audio":
        return encdec.forward(params, cfg, batch["tokens"], batch["frames"])
    return transformer.forward(params, cfg, batch["tokens"],
                               prefix_embeds=_prefix(cfg, batch))


def features(params, cfg: ModelConfig, batch: Dict):
    """Backbone + final norm, no unembed; returns (features, aux)."""
    require_ported(cfg)
    if cfg.family == "audio":
        return encdec.forward_features(params, cfg, batch["tokens"],
                                       batch["frames"])
    return transformer.forward_features(params, cfg, batch["tokens"],
                                        prefix_embeds=_prefix(cfg, batch))


def _token_nll(logits, labels, vocab: int):
    """Per-token negative log-likelihood in fp32 and the validity mask;
    the max is taken without gradient, as the JAX package's
    ``stop_gradient``."""
    logits = logits.float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    valid = (labels >= 0) & (labels < vocab)
    ll = torch.gather(logits, -1,
                      torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, lse - ll, 0.0), valid


def cross_entropy(logits, labels, vocab: int):
    """Mean next-token CE over the valid labels."""
    per_tok, valid = _token_nll(logits, labels, vocab)
    return per_tok.sum() / torch.clamp(valid.sum(), min=1)


class _VocabParallelNLL(torch.autograd.Function):
    """The summed next-token NLL of one chunk and its count of valid
    labels, where this rank holds the columns ``[v0, v0 + Vl)`` of the
    unembedding and the others the rest (``split``'s ranks): x (B, n, D)
    and w (D, Vl) in the compute dtype, labels (B, n).

    The forward forms the rows' log-sum-exp from two all-reduces over
    the split: the row maxima (MAX, no gradient, as the JAX package's
    ``stop_gradient``), then the local ``sum(exp(logits - max))`` and
    the label logit stacked in one SUM (a rank gives the label logit only
    where the label falls in its columns; labels outside ``[0, vocab)``
    are masked, and the padded columns count in the sum, as off the
    split). The backward is local: ``softmax - onehot`` on the rank's
    columns, ``dw`` its own slice, ``dx`` a partial that one SUM
    completes. Recomputed under ``checkpoint``, the forward issues the
    same collectives in the same order on every rank."""

    @staticmethod
    def forward(ctx, x, labels, w, v0, vocab, split):
        logits = (x @ w).float()
        Vl = logits.shape[-1]
        m = split.all_reduce(logits.amax(dim=-1), "max")
        e = torch.exp(logits - m[..., None])
        j = labels.long() - v0
        mine = (j >= 0) & (j < Vl)
        ll = torch.where(mine, torch.gather(
            logits, -1, j.clamp(0, Vl - 1)[..., None])[..., 0], 0.0)
        se, ll = split.all_reduce(torch.stack([e.sum(dim=-1), ll]))
        valid = (labels >= 0) & (labels < vocab)
        per_tok = torch.where(valid, torch.log(se) + m - ll, 0.0)
        ctx.save_for_backward(x, w, e, se, j, mine & valid, valid)
        ctx.split = split
        count = valid.sum().float()
        ctx.mark_non_differentiable(count)
        return per_tok.sum(), count

    @staticmethod
    def backward(ctx, g, _):
        x, w, e, se, j, hit, valid = ctx.saved_tensors
        dl = e / se[..., None]
        rows = hit.nonzero(as_tuple=True)
        dl[rows + (j[rows],)] -= 1.0
        dl = (dl * torch.where(valid, g, 0.0)[..., None]).to(x.dtype)
        dx = ctx.split.all_reduce((dl @ w.T).contiguous())
        dw = torch.einsum("bnd,bnv->dv", x, dl)
        return dx, None, dw, None, None, None


def _chunked_ce(x, labels, w, cfg: ModelConfig, chunk: int = CE_CHUNK):
    """Unembed + CE in sequence chunks of ``chunk`` positions (labels of
    the padded tail are -1): the (B, S, V) fp32 logits are never whole
    in memory (4.2 GB at vocab 128256, B=4, S=2048), and each chunk runs
    under a non-reentrant ``checkpoint``, so the backward recomputes its
    logits instead of keeping them.

    On a mesh (DTensor features) it runs on each rank's rows and the
    ranks' sums are added (``sharding.split_mean``). Where ``VOCAB``
    splits the unembedding over the model axis, the rows are replicated
    over it and each rank multiplies by its own columns only, the log-sum-
    exp formed across the ranks (``_VocabParallelNLL``); the unembedding
    is never whole. Elsewhere it is replicated and the rows split over
    every mesh dim that divides them."""
    cdt = cfg.dtype("compute")

    def sums(split, x, labels, w):
        B, S, _ = x.shape
        n = min(chunk, S)
        v0 = split.offset(0, 1)

        def one(xi, li):
            # each chunk casts the weight, as the JAX package does, so the
            # chunks' cotangents of fp32 masters add in fp32
            if split.groups:
                return _VocabParallelNLL.apply(xi.to(cdt), li, w.to(cdt),
                                               v0, cfg.vocab, split)
            per_tok, valid = _token_nll(xi.to(cdt) @ w.to(cdt), li,
                                        cfg.vocab)
            return per_tok.sum(), valid.sum().float()

        s_, c_ = [], []
        for c in range(math.ceil(S / n)):
            xi = x[:, c * n:(c + 1) * n]
            li = labels[:, c * n:(c + 1) * n]
            pad = n - xi.shape[1]
            if pad:
                xi = torch.cat([xi, xi.new_zeros(B, pad, xi.shape[2])], dim=1)
                li = torch.cat([li, li.new_full((B, pad), -1)], dim=1)
            s, k = checkpoint(one, xi, li, use_reentrant=False)
            s_.append(s)
            c_.append(k)
        return torch.stack(s_).sum(), torch.stack(c_).sum()

    return sh.split_mean(sums, (x, labels), (w,))


def loss_fn(params, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor,
                                                            Dict]:
    """Scalar training loss (the chunked CE plus the weighted MoE
    auxiliary terms) and its metrics. A VLM's loss covers its token
    positions only."""
    x, aux = features(params, cfg, batch)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:]
    ce = _chunked_ce(x, batch["labels"], transformer.unembed_weight(params,
                                                                    cfg),
                     cfg)
    total, metrics = ce, {"ce": ce}
    for k, wt in MOE_AUX_WEIGHTS.items():
        if k in aux:
            total = total + wt * aux[k]
            metrics[k] = aux[k]
    metrics["loss"] = total
    return total, metrics


class _ShapeSource:
    """A parameter source that draws nothing: ``meta`` tensors of each
    parameter's shape."""

    def p(self, shape, axes, **kw):
        return torch.empty(tuple(shape), device="meta")


def param_axes(cfg: ModelConfig):
    """The parameter tree with each leaf replaced by its logical axes
    (a tuple of ``dist.sharding`` names), from the same structure
    function as the weights (the JAX package's ``Builder("axes")``)."""
    from ..bridge import _ParamSource
    require_ported(cfg)
    return build_fn(cfg)(cfg, _ParamSource(cfg, mode="axes"))


def serve_parts(cfg: ModelConfig) -> Dict[str, tuple]:
    """The leaves of the parameter tree that concatenate several tensors
    along the dim the rules split over ``model``, by path, each as its
    parts (``ssm.serve_parts``; ``sharding.serve_slices`` cuts them part
    by part): the mamba mixers' of the ``ssm`` and ``hybrid`` families,
    none elsewhere."""
    if cfg.family not in ("ssm", "hybrid"):
        return {}
    return {f"layers/ssm/{k}": v for k, v in ssm.serve_parts(cfg).items()}


def make_rules(cfg: ModelConfig, mesh) -> sh.ShardingRules:
    """The config's ``ShardingRules`` on ``mesh`` (a ``DeviceMesh`` or a
    name -> size mapping)."""
    return sh.resolve_rules(
        mesh, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        d_ff=(cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff),
        vocab=cfg.padded_vocab,
        n_experts=(cfg.moe.n_experts if cfg.moe else 0),
        d_inner=cfg.d_inner)


def count_params(cfg: ModelConfig) -> int:
    require_ported(cfg)
    tree = build_fn(cfg)(cfg, _ShapeSource())

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return t.numel()
    return int(count(tree))


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters a token meets (MoE: top_k of the routed expert pool,
    plus the shared experts)."""
    total = count_params(cfg)
    if cfg.family != "moe":
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert * cfg.n_layers
    return total - per_expert * m.n_experts + per_expert * m.top_k
