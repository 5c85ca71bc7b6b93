"""Parameters for the port: from the JAX package's tree, or from a seed.

The port keeps the JAX package's parameter names and layouts (a dict
tree whose ``layers`` leaves carry the layer dim in front, ``wq`` as
``(L, d_model, H, hd)`` and so on), so one tree converts leaf for leaf.

For serving, weight matrices (embeddings, projections, biases, the
mamba conv) are cast to ``cfg.compute_dtype`` ONCE, here. The JAX
package casts them at every use (``transformer.attn_apply``,
``layers.swiglu``, the engine's embedding lookups), which in eager
PyTorch would copy every weight on every step. Leaves the JAX package
reads in fp32 stay in ``cfg.param_dtype``: the norm weights (``ln``,
``ln_*``) and the mamba recurrence's ``A_log``, ``dt_bias`` and
``D_skip``. Cast to bf16, ``A_log`` would change every channel's decay
``exp(dt * A)``.

For training, ``keep_param_dtype=True`` keeps EVERY leaf in
``cfg.param_dtype`` (the fp32 masters that AdamW updates), and the
train step casts the tree to the compute dtype once per step with
``compute_params``, a differentiable cast whose gradients come back in
fp32. The model then runs unchanged. This matches the JAX package's
cast-at-use in the forward, and in the backward too: ``embed`` and
``unembed`` stay in the param dtype in that tree, and the model casts
them at each use (the lookup casts the table, the unembedding each CE
chunk's weight), as the JAX package does. So the two bf16 cotangents
of a tied embedding, and the CE chunks' cotangents of the unembedding,
add in fp32. In fp32 compute every cast is the identity.
``opt_state_from_numpy`` carries the JAX package's ``AdamWState``
across.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .configs import ModelConfig, require_ported
from .models import rnn, ssm, transformer
from .optim import adamw


def _keeps_param_dtype(name: str) -> bool:
    return name == "ln" or name.startswith("ln_") or \
        name in ssm.PARAM_DTYPE_LEAVES


def _convert(tree, cfg, device, keep=False):
    if isinstance(tree, dict):
        return {k: _convert(v, cfg, device, keep or _keeps_param_dtype(k))
                for k, v in tree.items()}
    dt = cfg.dtype("param" if keep else "compute")
    return torch.from_numpy(np.array(tree)).to(device, dt)


def from_numpy(params_np: Dict[str, Any], cfg: ModelConfig,
               device="cuda", keep_param_dtype: bool = False
               ) -> Dict[str, Any]:
    """The JAX package's parameter tree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, init_params(...))``), as the port's
    parameter tree on ``device``: weight matrices in the compute dtype,
    or every leaf in the param dtype with ``keep_param_dtype``."""
    require_ported(cfg)
    return _convert(params_np, cfg, resolve_device(device),
                    keep=keep_param_dtype)


# Leaves the model casts at each use (the embedding lookup, the
# unembedding), so that each use has its own cast, as in the JAX package.
CAST_AT_USE = ("embed", "unembed")


def compute_params(params: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The master tree (``keep_param_dtype=True``) as the model runs
    it: every leaf cast to the compute dtype except those the model
    reads in the param dtype (``_keeps_param_dtype``) and those it casts
    at each use (``CAST_AT_USE``). The cast is differentiable; in fp32
    compute it returns the leaves themselves."""
    def cast(tree, keep=False):
        if isinstance(tree, dict):
            return {k: cast(v, keep or _keeps_param_dtype(k))
                    for k, v in tree.items()}
        return tree if keep else tree.to(cfg.dtype("compute"))
    out = cast(params)
    out.update({k: params[k] for k in CAST_AT_USE if k in params})
    return out


def opt_state_from_numpy(state_np, device="cuda") -> adamw.AdamWState:
    """The JAX package's ``AdamWState`` (step, mu, nu), its leaves as
    numpy arrays, as the port's: the step a Python int, the moments
    fp32 trees on ``device``."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, np.float32)).to(device)

    step, mu, nu = state_np
    return adamw.AdamWState(step=int(np.asarray(step)), mu=conv(mu),
                            nu=conv(nu))


class _ParamSource:
    """Draws one tensor per ``p`` call, following the parameter
    factory of the JAX package's ``models/params.py``: fan-in normal
    (fan-in defaults to ``shape[-2]``), ones, zeros, or a plain normal.
    Tensors land in the compute dtype, except norm weights (ones) and
    those drawn with ``param_dtype=True``, which stay in the param
    dtype."""

    def __init__(self, cfg, gen, device, keep_param_dtype=False):
        self.gen, self.device = gen, device
        self.pdt = cfg.dtype("param")
        self.cdt = self.pdt if keep_param_dtype else cfg.dtype("compute")

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


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                keep_param_dtype: bool = False) -> Dict[str, Any]:
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
    scale, as in a trained model.

    ``keep_param_dtype=True`` keeps every leaf in the param dtype (the
    training masters); the draws are the same numbers before the cast."""
    require_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return transformer.build_params(
        cfg, _ParamSource(cfg, gen, device, keep_param_dtype))


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
