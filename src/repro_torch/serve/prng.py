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
  (``torch.argmax`` takes the first maximal index, as ``jnp.argmax``);
- ``split(key, num)``: in the partitionable mode the hash of the
  counter pairs ``(i >> 32, i & 0xFFFFFFFF)``, ``i < num``, both output
  words kept (``_threefry_split_foldlike``);
- ``randint``: JAX's two-draw modular method (``_randint``): split the
  key, draw 32 bits from each half, and reduce ``hi * (2**32 mod span)
  + lo`` modulo ``span`` in uint32 arithmetic; ``maxval`` may be a
  device tensor (a bound that lives on the card);
- ``normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform on JAX's open
  interval ``(nextafter(-1, 0), 1)``, ``erfinv`` being XLA's
  single-precision polynomial (Giles 2010, the constants of XLA's
  ``ErfInv32``) evaluated in float32.

The keys, bits, uniforms and integers equal JAX's exactly; the Gumbel
noise goes through PyTorch's ``log``, which may differ from XLA's by an
ulp, and ``normal`` through PyTorch's ``log1p`` and ``sqrt`` inside the
polynomial: 3 float32 ulps at most from JAX's on 10^6 draws, 99% of
them equal (``tests/test_torch_dqn.py`` holds it to 4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "randint", "normal", "gumbel", "categorical"]

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


def _hash_counters(key: torch.Tensor, shape: Sequence[int]):
    """Both threefry output words of the counters ``0 .. prod(shape)-1``
    (row-major) under a batch of keys ``(..., 2)``: two ``(...) +
    shape`` tensors."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(max(n, 1), dtype=torch.int64,
                       device=key.device)[:n].reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, idx >> 32, idx & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable mode) for a batch of
    keys: key ``(..., 2)`` -> ``(..., num, 2)``."""
    b1, b2 = _hash_counters(key, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable mode) for
    a batch of keys: key ``(..., 2)`` -> ``(...) + shape`` int64 values
    in [0, 2**32)."""
    b1, b2 = _hash_counters(key, shape)
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


def randint(key: torch.Tensor, shape: Sequence[int], minval, maxval
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for one
    key ``(2,)``: int64 values in ``[minval, maxval)``, or ``minval``
    where ``maxval <= minval``. ``minval``/``maxval`` are ints or
    integer tensors that broadcast to ``shape`` (a device tensor is
    never read). Spans up to 2**31 are exact: every product below stays
    inside int64 before it is reduced to 32 bits."""
    shape = tuple(shape)
    k1, k2 = split(key, 2).unbind(-2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    lo_v, hi_v = (v.to(torch.int64) if torch.is_tensor(v) else
                  torch.full((), int(v), dtype=torch.int64,
                             device=key.device)     # a fill, no copy
                  for v in (minval, maxval))
    span = torch.where(hi_v <= lo_v, 1, (hi_v - lo_v) & _M32)
    mult = (1 << 16) % span
    mult = (mult * mult & _M32) % span
    off = ((hi % span) * mult & _M32) + (lo % span) & _M32
    return (lo_v + off % span).expand(shape)


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# polynomial's coefficients for w < 5 and w >= 5, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``. XLA contracts each Horner step
    ``c + p * w`` into a fused multiply-add; the step runs here in
    float64 (the float32 product is exact there) and rounds to float32
    once, as the fused operation does."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).float()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, a, b).float().double()
        p = (c + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32) for a batch of keys
    ``(..., 2)`` -> ``(...) + shape``."""
    u = uniform(key, shape, minval=_NORMAL_LO, maxval=1.0)
    return float(np.float32(np.sqrt(2))) * erfinv(u)


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
