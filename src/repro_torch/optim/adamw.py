"""AdamW with global-norm clipping, as the JAX package's
``optim/adamw.py``: bias correction, decoupled weight decay, moments in
fp32. Functional, like the reference: ``apply`` returns new parameter
and state trees (dicts and lists of tensors) and changes nothing in
place. The step count is a Python int on the host, so the bias
corrections and the learning-rate schedule cost no device read."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable] = None  # step -> multiplier


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, mu=pytree.tree_map(zeros, params),
                      nu=pytree.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum()
                          for l in pytree.tree_leaves(tree)))


def apply(cfg: AdamWConfig, params, grads, state: AdamWState
          ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One update. Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule else 1.0)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        d = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return (p.float() - lr * d).to(p.dtype), mu, nu

    flat_p, spec = pytree.tree_flatten(params)
    out = [upd(p, g, m, n) for p, g, m, n in zip(
        flat_p, pytree.tree_leaves(grads), pytree.tree_leaves(state.mu),
        pytree.tree_leaves(state.nu))]
    new_p = pytree.tree_unflatten([o[0] for o in out], spec)
    new_mu = pytree.tree_unflatten([o[1] for o in out], spec)
    new_nu = pytree.tree_unflatten([o[2] for o in out], spec)
    metrics = {"grad_norm": gnorm, "lr": float(lr)}
    return new_p, AdamWState(step, new_mu, new_nu), metrics


def state_axes(param_axes) -> AdamWState:
    """Logical axes for the optimizer state (mirrors params; ZeRO-style)."""
    return AdamWState(step=(), mu=param_axes, nu=param_axes)
