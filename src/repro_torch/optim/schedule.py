"""LR schedules (warmup + cosine/linear), as step -> multiplier
functions.

Port of ``repro/optim/schedule.py``. The port's AdamW passes the step
as a Python int, so a schedule costs no device work; it computes in
float32, in the JAX function's order of operations, and returns the
float32 result as a Python float. It agrees with the JAX function to
two float32 ulps of 1.0: under ``jit`` XLA divides by a constant
through its reciprocal, contracts multiply-adds and has its own
``cos``.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def _cosine(step, warmup_steps, total_steps, final_frac):
    s = _F(step)
    warm = s / _F(max(warmup_steps, 1))
    t = (s - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1))
    t = np.clip(t, _F(0.0), _F(1.0))
    cos = _F(final_frac) + _F((1 - final_frac) * 0.5) * (
        _F(1.0) + np.cos(_F(np.pi) * t))
    return float(warm if step < warmup_steps else cos)


def _linear(step, warmup_steps, total_steps, final_frac):
    s = _F(step)
    warm = s / _F(max(warmup_steps, 1))
    t = (s - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1))
    lin = _F(1.0) - _F(1.0 - final_frac) * np.clip(t, _F(0.0), _F(1.0))
    return float(warm if step < warmup_steps else lin)


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    return lambda step: _cosine(int(step), warmup_steps, total_steps,
                                final_frac)


def warmup_linear(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0):
    return lambda step: _linear(int(step), warmup_steps, total_steps,
                                final_frac)


def constant():
    return lambda step: 1.0
