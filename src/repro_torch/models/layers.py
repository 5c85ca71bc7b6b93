"""Shared building blocks: norms, RoPE, the SwiGLU MLP.

Port of ``repro/models/layers.py``. Same arithmetic: norms run in fp32
and cast back; RoPE uses the JAX package's frequency formula
``exp(-log(theta) * i / half)``, not ``theta ** (-i / half)``, whose
fp32 rounding differs enough to break fp32 parity.
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
    are already in ``compute_dtype`` (cast once at load)."""
    x = x.to(compute_dtype)
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
