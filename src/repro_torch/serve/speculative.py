"""In-graph speculative decoding: draft k, verify once.

Port of ``repro/serve/speculative.py``. Each decode iteration of the
scheduler's segment:

1. **drafts** k candidate tokens per running slot, with ``draft_ngram``
   (prompt lookup over the slot's resident prompt and its own emitted
   tokens: integer compares and gathers, no model) or with a small
   draft model (wired by the scheduler: k+1 ``decode_step``s against
   the draft's own cache);
2. **verifies** the k+1 positions ``[pending, d_1..d_k]`` in ONE target
   forward through the cache (``engine.verify_step``: the window's K/V
   written at the slot's offset, then decode-exact
   ``verify_attention``; through the chunk kernel's ``flash_verify``
   entry on a paged cache under ``attn_impl="cuda"``);
3. **accepts** a data-dependent prefix (``accept``): greedy match under
   greedy sampling, so the emitted stream is the sequential decode's;
   rejection sampling under temperature, each position's randomness
   drawn from the key its emission index owns (``sampling.window_keys``).

Rejected drafts need no rollback of the cache: ``cur_len`` advances by
``accepted + 1`` and the next window, starting at ``cur_len - 1``,
rewrites every stale lane before a query can see it. Everything here is
integer compares, gathers and fp32 math on the device, with no host read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import prng
from . import sampling as sampling_lib


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """k: drafted candidates per iteration (the verify window is k+1
    wide). drafter: "ngram" (prompt lookup, no extra model) or "model"
    (a small LM with the target's vocab drafts k+1 steps against its own
    cache; the scheduler takes ``draft_params``/``draft_cfg``). ngram:
    trailing tokens the lookup must match."""

    k: int = 4
    drafter: str = "ngram"
    ngram: int = 2

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1; got {self.k}")
        if self.drafter not in ("ngram", "model"):
            raise ValueError(f"drafter must be 'ngram' or 'model'; "
                             f"got {self.drafter!r}")
        if self.ngram < 1:
            raise ValueError(f"ngram must be >= 1; got {self.ngram}")


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, idx)


def draft_ngram(prompt: torch.Tensor, prompt_lens: torch.Tensor,
                out: torch.Tensor, n_emitted: torch.Tensor,
                next_token: torch.Tensor, *, k: int,
                ngram: int) -> torch.Tensor:
    """Prompt-lookup drafter: k candidates per row -> ``(n, k)`` int32.

    Each row's context is ``prompt ++ emitted ++ pending``. The latest
    earlier position whose trailing ``ngram`` tokens match the context's
    last ``ngram`` wins, and the k tokens after it are proposed (clamped
    into the context); with no match the pending token is proposed k
    times. prompt: (n, P) right-padded; prompt_lens: (n,) true lengths;
    out/n_emitted: the pool's emissions and their counts; next_token:
    (n,) pending tokens."""
    n, P = prompt.shape
    cap = out.shape[1]
    W = P + cap + 1
    dev = out.device
    jj = torch.arange(W, device=dev)[None].expand(n, W)
    pl = prompt_lens.long()[:, None]
    ne = n_emitted.long()[:, None]
    m_len = pl + ne + 1                        # context length per row
    cp = (_take(prompt.long(), jj.clamp(0, P - 1)) if P > 0
          else torch.zeros((n, W), dtype=torch.long, device=dev))
    co = _take(out.long(), (jj - pl).clamp(0, cap - 1))
    ctx = torch.where(jj < pl, cp,
                      torch.where(jj < pl + ne, co,
                                  next_token.long()[:, None]))
    ctx = torch.where(jj < m_len, ctx, -1)     # -1 never matches a token
    ok = (jj >= ngram - 1) & (jj <= m_len - 2)
    for r in range(ngram):
        tail_r = _take(ctx, (m_len - 1 - r).clamp(0, W - 1))      # (n, 1)
        shift_r = _take(ctx, (jj - r).clamp(0, W - 1))
        ok = ok & (shift_r == tail_r)
    pbest = torch.where(ok, jj, -1).amax(dim=1)                   # (n,)
    src = (pbest[:, None] + 1 + torch.arange(k, device=dev)).clamp(0, W - 1)
    src = torch.minimum(src, m_len - 1)
    props = _take(ctx, src)
    return torch.where(pbest[:, None] >= 0, props,
                       next_token.long()[:, None]).to(torch.int32)


def accept(logits: torch.Tensor, drafts: torch.Tensor,
           keys: Optional[torch.Tensor], sp: sampling_lib.SamplingParams):
    """Accept a per-row draft prefix from one verify forward.

    logits: (n, k+1, V), position j scoring the token at emission index
    ``n_emitted + j + 1``; drafts: (n, k); keys: (n, k+1, 2) per-emission
    keys for those indices (``sampling.window_keys``; None under greedy).
    Returns ``(acc, nxt)``: acc (n,) in [0, k], the accepted prefix
    length; nxt (n,) int32, the new pending token.

    Greedy: accept while ``d_{j+1} == argmax(logits[:, j])``.
    Temperature: a deterministic proposal, so rejection sampling accepts
    d with probability p(d) under the filtered distribution
    (``sampling.filtered_logits``), and on rejection draws from p with
    d's mass removed; the accept uniform and the draw use the sub-keys
    ``fold_in(key_e, 0)`` and ``fold_in(key_e, 1)`` of the position's
    emission key."""
    n, w, V = logits.shape
    k = w - 1
    rows = torch.arange(n, device=logits.device)
    if sp.greedy:
        g = torch.argmax(logits, dim=-1)                          # (n, k+1)
        match = (drafts.long() == g[:, :k]).long()
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        return acc, g[rows, acc].to(torch.int32)
    f = sampling_lib.filtered_logits(logits, sp)                  # (n, k+1, V)
    p = torch.softmax(f, dim=-1)
    p_draft = torch.gather(p[:, :k], 2, drafts.long()[..., None])[..., 0]
    u = prng.uniform(prng.fold_in(keys[:, :k], 0))                # (n, k)
    acc = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)
    # the continuation for every stop position, selected by acc: the
    # residual where a draft was rejected, a plain draw after all k
    hit = torch.zeros((n, k, V), dtype=torch.bool, device=logits.device)
    hit.scatter_(2, drafts.long()[..., None], True)
    resid = torch.where(hit, -torch.inf, f[:, :k])
    cand = torch.cat([resid, f[:, k:]], dim=1)                    # (n, k+1, V)
    nxt_all = prng.categorical(prng.fold_in(keys, 1), cand)       # (n, k+1)
    return acc, nxt_all[rows, acc].to(torch.int32)


def validate(spec: SpecConfig, cfg, prefill: str, draft_cfg: Optional[Any],
             draft_params, prefix_len: int = 0) -> None:
    """The scheduler's construction checks for a speculative pool."""
    if prefill != "chunked":
        raise ValueError(
            "speculative decoding requires prefill='chunked': the drafter "
            "reads the pool's resident prompt buffer and verification "
            "rides the chunked write path (per-row offset windows), "
            "neither of which the one-shot pool has")
    if spec.drafter == "model":
        if draft_cfg is None or draft_params is None:
            raise ValueError("drafter='model' needs draft_params and "
                             "draft_cfg")
        if draft_cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"draft model must be an attention-decoder LM "
                f"(dense/moe); got family {draft_cfg.family!r}")
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError(
                f"draft vocab ({draft_cfg.vocab}) must equal the target "
                f"vocab ({cfg.vocab}): drafted ids are fed straight to "
                f"the target verifier")
        if prefix_len:
            raise ValueError(
                "drafter='model' does not support a patch prefix (the "
                "draft model cannot consume the target's patch embeds); "
                "use drafter='ngram' for VLM pools")
    elif draft_cfg is not None or draft_params is not None:
        raise ValueError("draft_params/draft_cfg given but "
                         "spec.drafter != 'model'")
