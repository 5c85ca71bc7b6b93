"""Token-sampling policy for the serve layer.

Port of ``repro/serve/sampling.py``, greedy decoding only. Sampled
decoding waits for a port of the JAX package's threefry ``fold_in`` and
Gumbel ``categorical`` draw, without which sampled streams could not be
held to the JAX package's (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 means greedy argmax; top_k is ignored then, as
    in the JAX package."""

    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.temperature > 0.0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet: it "
                "waits for the threefry PRNG port; see ROADMAP.md")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sample_slots(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """Per-slot greedy tokens from ``logits (n_slots, V)`` -> int32.
    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``
    does, so ties break the same way."""
    del sp  # greedy is the only policy SamplingParams admits
    return torch.argmax(logits, dim=-1).to(torch.int32)
