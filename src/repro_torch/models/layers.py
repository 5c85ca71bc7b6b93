"""Shared building blocks: norms, RoPE, sinusoidal positions, the
SwiGLU and GELU MLPs.

Port of ``repro/models/layers.py``. Same arithmetic: norms run in fp32
and cast back; RoPE uses the JAX package's frequency formula
``exp(-log(theta) * i / half)``, not ``theta ** (-i / half)``, whose
fp32 rounding differs enough to break fp32 parity; sinusoids divide the
fp32 position by ``10000 ** (2 i / d)`` and cast last, as the JAX
package does; the GELU is the tanh approximation
(``jax.nn.gelu(approximate=True)``), not the erf form.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def rms_norm(x, weight=None, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dt)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(kind: str, x, params, name: str):
    """kind: rmsnorm | layernorm | nonparametric_ln (OLMo)."""
    if kind == "rmsnorm":
        return rms_norm(x, params[name])
    if kind == "layernorm":
        return layer_norm(x, params[name], params.get(name + "_b"))
    if kind == "nonparametric_ln":
        return layer_norm(x, None, None)
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device):
    """fp32 inverse frequencies, computed once per (width, theta,
    device) so that a step does not copy them to the device per layer."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    return torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32)
                     / half).to(device)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., seq, heads, head_dim); positions
    (..., seq) integer."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, compute_dtype):
    """SwiGLU MLP: (silu(x @ w_gate) * (x @ w_up)) @ w_down. The weights
    are already in ``compute_dtype`` (cast once at load). On a rank's
    columns of the hidden width (``MLP`` on a serving mesh's model axis)
    the result is its part of the sum over that width, which the caller
    sums over the axis (``sharding.ServeSplit.sum_parts``)."""
    x = x.to(compute_dtype)
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


@functools.lru_cache(maxsize=None)
def _sinusoid_inv(d: int, device: torch.device):
    """``10000 ** (2 i / d)`` for i < d / 2, the fp32 exponent as the
    JAX package forms it, the power taken in fp64 and rounded once to
    fp32; once per (width, device), so that a decode step inside a
    captured segment copies nothing to the device."""
    expo = 2 * torch.arange(d // 2, dtype=torch.float32) / d
    return torch.pow(torch.tensor(10000.0, dtype=torch.float64),
                     expo.double()).float().to(device)


def sinusoidal_positions(n: int, d: int, dtype=torch.float32,
                         device="cpu"):
    """(n, d) sinusoidal embeddings of positions ``[0, n)``: sines then
    cosines, computed in fp32 and cast to ``dtype``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    angle = pos / _sinusoid_inv(d, torch.device(device))[None, :]
    return torch.cat([torch.sin(angle), torch.cos(angle)],
                     dim=-1).to(dtype)


def sinusoid_at(pos, d: int, dtype=torch.float32):
    """Sinusoidal embedding at position(s) ``pos``, an integer tensor: a
    scalar gives (d,), a (B,) vector (per-slot decode positions) (B, d),
    any shape ``pos.shape + (d,)``."""
    angle = pos.float()[..., None] / _sinusoid_inv(d, pos.device)
    return torch.cat([torch.sin(angle), torch.cos(angle)],
                     dim=-1).to(dtype)


def gelu_mlp(x, w_in, b_in, w_out, b_out, compute_dtype):
    """GELU MLP with biases: gelu_tanh(x @ w_in + b_in) @ w_out + b_out
    (``b_out`` None: without it). The weights are already in
    ``compute_dtype`` (cast once at load)."""
    x = x.to(compute_dtype)
    h = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return h if b_out is None else h + b_out
