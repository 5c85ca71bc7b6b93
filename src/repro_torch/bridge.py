"""Parameters for the port: from the JAX package's tree, or from a seed.

The port keeps the JAX package's parameter names and layouts (a dict
tree whose ``layers`` leaves carry the layer dim in front, ``wq`` as
``(L, d_model, H, hd)`` and so on), so one tree converts leaf for leaf.

Weight matrices (embeddings, projections, biases, the mamba conv) are
cast to ``cfg.compute_dtype`` ONCE, here. The JAX package casts them at
every use (``transformer.attn_apply``, ``layers.swiglu``, the engine's
embedding lookups), which in eager PyTorch would copy every weight on
every step. Leaves the JAX package reads in fp32 stay in
``cfg.param_dtype``: the norm weights (``ln``, ``ln_*``) and the mamba
recurrence's ``A_log``, ``dt_bias`` and ``D_skip``. Cast to bf16,
``A_log`` would change every channel's decay ``exp(dt * A)``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .configs import ModelConfig, require_ported
from .models import rnn, ssm, transformer


def _keeps_param_dtype(name: str) -> bool:
    return name == "ln" or name.startswith("ln_") or \
        name in ssm.PARAM_DTYPE_LEAVES


def _convert(tree, cfg, device, keep=False):
    if isinstance(tree, dict):
        return {k: _convert(v, cfg, device, _keeps_param_dtype(k))
                for k, v in tree.items()}
    dt = cfg.dtype("param" if keep else "compute")
    return torch.from_numpy(np.array(tree)).to(device, dt)


def from_numpy(params_np: Dict[str, Any], cfg: ModelConfig,
               device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, init_params(...))``), as the port's
    parameter tree on ``device``."""
    require_ported(cfg)
    return _convert(params_np, cfg, resolve_device(device))


class _ParamSource:
    """Draws one tensor per ``p`` call, following the parameter
    factory of the JAX package's ``models/params.py``: fan-in normal
    (fan-in defaults to ``shape[-2]``), ones, zeros, or a plain normal.
    Tensors land in the compute dtype, except norm weights (ones) and
    those drawn with ``param_dtype=True``, which stay in the param
    dtype."""

    def __init__(self, cfg, gen, device):
        self.gen, self.device = gen, device
        self.pdt, self.cdt = cfg.dtype("param"), cfg.dtype("compute")

    def p(self, shape, *, init="fan_in", scale=1.0, fan_in=0,
          param_dtype=False):
        shape = tuple(shape)
        dt = self.pdt if param_dtype or init == "ones" else self.cdt
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=self.device)
        if init == "fan_in":
            fi = fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
            scale = scale / math.sqrt(max(fi, 1))
        elif init != "normal":
            raise ValueError(init)
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=self.pdt)
        return t.mul_(scale).to(dt)


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters of the JAX package's shapes and init rules
    (``transformer.build_params`` over a source that follows
    ``models/params.py``), drawn from a ``torch.Generator`` seeded with
    ``seed``. The numbers differ from the JAX package's draws.

    One scale differs on purpose: ``wq``/``wk``/``wv`` are drawn with
    their true fan-in, ``d_model`` (``transformer.attn_params``).
    ``models/params.py`` takes the fan-in from ``shape[-2]`` of the
    stacked shape, which for these weights is the head count. At
    llama3.2-1b's width that makes q and k 8x and 16x too large,
    attention scores reach a std of ~128 and the softmax becomes an
    argmax, so a last-bit difference in any sum flips which key wins,
    and random-weight runs of two correct implementations diverge
    within one prompt chunk. With the true fan-in the scores have unit
    scale, as in a trained model."""
    require_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return transformer.build_params(cfg, _ParamSource(cfg, gen, device))


def lstm_params_from_numpy(tree, device="cuda"):
    """An LSTM parameter tree of the JAX package, its leaves as numpy
    arrays, as the port's tree on ``device``: ``lstm_init``'s
    ``{"w", "b"}``, ``multilayer_lstm_params``' list of them, or the NMT
    example's ``{"embed", "enc", "dec", "out"}``. Dicts and lists keep
    their structure; every array keeps its dtype."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return torch.from_numpy(np.array(t)).to(device)

    return conv(tree)


def init_lstm_params(input_dim: int, hidden: int, seed: int = 0,
                     device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random LSTM weights at full width by ``rnn.lstm_init``'s rule,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return rnn.lstm_init(gen, input_dim, hidden, dtype)
