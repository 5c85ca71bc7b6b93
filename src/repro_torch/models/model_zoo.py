"""Unified model entry for the ported families: forward, features, the
loss and the parameter count.

Port of ``repro/models/model_zoo.py`` (``forward``, ``features``,
``cross_entropy``, ``_chunked_ce``, ``loss_fn``, ``count_params``) for
the dense and pure-SSM families. The MoE auxiliary terms, the VLM patch
prefix and the audio encoder-decoder wait for their families' slices
(ROADMAP.md). ``batch`` is a dict of tensors: ``tokens`` (B, S) and,
for the loss, ``labels`` (B, S); labels outside ``[0, vocab)`` are
masked.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import ModelConfig, require_ported
from . import transformer

CE_CHUNK = 512


def forward(params, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor,
                                                            Dict]:
    """Full-sequence logits (B, S, padded_vocab) and the (empty) aux
    dict."""
    require_ported(cfg)
    return transformer.forward(params, cfg, batch["tokens"]), {}


def features(params, cfg: ModelConfig, batch: Dict):
    """Backbone + final norm, no unembed; returns (features, aux)."""
    require_ported(cfg)
    return transformer.forward_features(params, cfg, batch["tokens"]), {}


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


def _chunked_ce(x, labels, w, cfg: ModelConfig, chunk: int = CE_CHUNK):
    """Unembed + CE in sequence chunks of ``chunk`` positions (labels of
    the padded tail are -1): the (B, S, V) fp32 logits are never whole
    in memory (4.2 GB at vocab 128256, B=4, S=2048), and each chunk runs
    under a non-reentrant ``checkpoint``, so the backward recomputes its
    logits instead of keeping them."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    cdt = cfg.dtype("compute")

    def one(xi, li):
        # each chunk casts the weight, as the JAX package does, so the
        # chunks' cotangents of fp32 masters add in fp32
        per_tok, valid = _token_nll(xi.to(cdt) @ w.to(cdt), li, cfg.vocab)
        return per_tok.sum(), valid.sum().float()

    sums, counts = [], []
    for c in range(math.ceil(S / chunk)):
        xi = x[:, c * chunk:(c + 1) * chunk]
        li = labels[:, c * chunk:(c + 1) * chunk]
        pad = chunk - xi.shape[1]
        if pad:
            xi = torch.cat([xi, xi.new_zeros(B, pad, xi.shape[2])], dim=1)
            li = torch.cat([li, li.new_full((B, pad), -1)], dim=1)
        s, n = checkpoint(one, xi, li, use_reentrant=False)
        sums.append(s)
        counts.append(n)
    return torch.stack(sums).sum() / torch.clamp(torch.stack(counts).sum(),
                                                 min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor,
                                                            Dict]:
    """Scalar training loss (the chunked CE) and its metrics."""
    x, _ = features(params, cfg, batch)
    ce = _chunked_ce(x, batch["labels"], transformer.unembed_weight(params,
                                                                    cfg),
                     cfg)
    return ce, {"ce": ce, "loss": ce}


class _ShapeSource:
    """A parameter source that draws nothing: ``meta`` tensors of each
    parameter's shape."""

    def p(self, shape, **kw):
        return torch.empty(tuple(shape), device="meta")


def count_params(cfg: ModelConfig) -> int:
    require_ported(cfg)
    tree = transformer.build_params(cfg, _ShapeSource())

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return t.numel()
    return int(count(tree))
