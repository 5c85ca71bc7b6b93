"""The part of ``jax.random`` that sampled decoding uses, bit for bit,
as integer tensor ops on raw threefry keys.

A key is an int64 tensor ``(..., 2)`` holding the two uint32 words of a
JAX raw ``threefry2x32`` key (JAX stores them as uint32; PyTorch has no
arithmetic on uint32, so the words live in int64 and every add and
shift is masked back to 32 bits). Everything is elementwise on the
device, with no host read, so it can run inside a captured CUDA graph.

The JAX package runs JAX 0.9 with ``jax_threefry_partitionable=True``
and without x64, and these functions reproduce that mode:

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds
  (``jax/_src/prng.py``, ``_threefry2x32_lowering``);
- ``prng_key(seed)``: ``jax.random.PRNGKey(seed)``; without x64 the seed
  is a 32-bit integer, so the high word is 0 and the low word is
  ``seed mod 2**32``;
- ``fold_in(key, data)``: the hash of the counter pair ``(0, data)``;
- ``random_bits(key, shape)``: 32 random bits per element; in the
  partitionable mode element ``i`` (row-major flat index) hashes the
  counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and returns the XOR of the
  two output words;
- ``uniform``: the bits' top 23 as a float in [1, 2), minus 1, scaled,
  then ``max(minval, .)``;
- ``gumbel`` (JAX's default mode ``"low"``): ``-log(-log(uniform(
  minval=tiny)))``;
- ``categorical``: ``argmax(gumbel + logits)`` over the last axis
  (``torch.argmax`` takes the first maximal index, as ``jnp.argmax``).

The bits and the uniforms equal JAX's exactly; the Gumbel noise goes
through PyTorch's ``log``, which may differ from XLA's by an ulp.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    words ``(k1, k2)``; int64 tensors of uint32 values that broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over broadcast batches: key ``(..., 2)``,
    data an integer tensor (its low 32 bits are folded in) or an int.
    Returns ``broadcast(key[..., 0], data) + (2,)``. An int is filled on
    the device (no host-to-device copy, which a graph capture refuses)."""
    if torch.is_tensor(data):
        data = data.long() & _M32
    else:
        data = torch.full_like(key[..., 0], int(data) & _M32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable mode) for
    a batch of keys: key ``(..., 2)`` -> ``(...) + shape`` int64 values
    in [0, 2**32)."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(max(n, 1), dtype=torch.int64,
                       device=key.device)[:n].reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (), *,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for a
    batch of keys ``(..., 2)`` -> ``(...) + shape`` float32."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * scale + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, mode ``"low"``)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for a batch:
    key ``(..., 2)``, logits ``(..., V)`` -> ``(...)`` int64 ids. Row r
    draws its Gumbel noise from ``key[r]`` over its own V lanes, as
    ``jax.vmap`` of a per-row draw does."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits.float(), dim=-1)
