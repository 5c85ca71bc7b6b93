"""Token-sampling policies for the serve layer.

Port of ``repro/serve/sampling.py``: greedy argmax, temperature, top-k,
with the JAX package's PRNG threading. Every request carries its own
threefry key (``serve.prng``: int64 ``(2,)`` words, bit-equal to JAX's
raw uint32 key); the token at emission index ``j`` draws from
``fold_in(request_key, j)``. A sampled stream therefore depends only on
(request key, logits), never on the slot the request landed in or on
what else shares the pool, and for the same key and logits it equals
the JAX package's.

Draws span every lane of the logits (``padded_vocab`` in the engine),
as the JAX package's do. Everything runs on the device with no host
read, so a captured graph can hold it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 means greedy argmax (the key is unused then);
    top_k == 0 disables top-k filtering."""

    temperature: float = 0.0
    top_k: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _check_top_k(logits: torch.Tensor, sp: SamplingParams) -> None:
    if sp.top_k > logits.shape[-1]:
        raise ValueError(
            f"top_k={sp.top_k} exceeds the vocab size "
            f"{logits.shape[-1]}; top_k must be in [0, vocab]")


def filtered_logits(logits: torch.Tensor,
                    sp: SamplingParams) -> torch.Tensor:
    """Temperature-scaled, top-k-filtered fp32 logits ``(..., V)``:
    exactly the distribution ``sample`` draws from (speculative
    acceptance scores drafts against it too).

    Top-k keeps EXACTLY k candidates: every entry above the k-th value,
    then the ties with it in index order, lowest first (``lax.top_k``'s
    rule), so bf16 logits rounded into ties never let more than k
    through."""
    scaled = logits.float() / sp.temperature
    if sp.top_k > 0:
        kth = torch.topk(scaled, sp.top_k, dim=-1).values[..., -1:]
        gt = scaled > kth
        n_gt = gt.sum(dim=-1, keepdim=True)
        tie = scaled == kth
        tie_rank = torch.cumsum(tie.int(), dim=-1)
        keep = gt | (tie & (tie_rank <= sp.top_k - n_gt))
        scaled = torch.where(keep, scaled, -torch.inf)
    return scaled


def sample(logits: torch.Tensor, key: Optional[torch.Tensor],
           sp: SamplingParams) -> torch.Tensor:
    """Token ids from ``logits (..., V)`` -> ``(...)`` int32; ``key``
    ``(..., 2)`` gives each row its own draw (None under greedy)."""
    _check_top_k(logits, sp)
    if sp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, filtered_logits(logits, sp)).to(torch.int32)


def sample_slots(logits: torch.Tensor, keys: Optional[torch.Tensor],
                 sp: SamplingParams) -> torch.Tensor:
    """Per-slot sampling: ``logits (n_slots, V)``, ``keys (n_slots, 2)``
    (None under greedy) -> ``(n_slots,)`` int32. ``torch.argmax`` takes
    the first maximal index, as ``jnp.argmax`` does."""
    return sample(logits, keys, sp)


def step_keys(keys: torch.Tensor, emitted) -> torch.Tensor:
    """Fold per-slot emission indices into per-slot request keys: keys
    ``(n, 2)``, emitted ``(n,)``, the emission index of the token about
    to be sampled. Keyed by emission index, never by iteration, so a
    speculative iteration that emits several tokens draws the same keys
    as one-token iterations would."""
    return prng.fold_in(keys, emitted)


def window_keys(keys: torch.Tensor, first: torch.Tensor,
                width: int) -> torch.Tensor:
    """Per-emission keys for a ``width``-token window: ``(n, width, 2)``
    where ``[:, j]`` equals ``step_keys(keys, first + j)``."""
    idx = first.long()[:, None] + torch.arange(width, device=first.device)
    return prng.fold_in(keys[:, None], idx)
