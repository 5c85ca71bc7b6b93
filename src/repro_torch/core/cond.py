"""``cond(pred, true_fn, false_fn)`` (paper §2.1, compiled per §4.2).

Two lowerings, as in the JAX package:

- ``backend="native"``: exactly one branch runs. The predicate is
  brought to the host (a tensor is read once), which is the eager
  counterpart of ``lax.cond`` on one device.
- ``backend="select"``: both branches run and ``torch.where`` keeps the
  taken one, the masked form of the paper's deadness (§4.4) that the
  JAX package uses inside partitioned stages. The predicate stays on
  the device: no host read.

Both are differentiable by autograd: the native path records only the
taken branch (the paper's §5.1 rule, the gradient of a cond is a cond
on the same predicate), the select path differentiates as a select.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree


def cond(pred, true_fn: Callable, false_fn: Callable, *operands: Any,
         backend: str = "native") -> Any:
    """Conditional computation; returns the taken branch's outputs."""
    if backend == "native":
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    if backend == "select":
        t_out = true_fn(*operands)
        f_out = false_fn(*operands)

        def select(t, f):
            t, f = torch.as_tensor(t), torch.as_tensor(f)
            p = torch.as_tensor(pred, device=t.device)
            return torch.where(p, t, f)

        return pytree.tree_map(select, t_out, f_out)
    raise ValueError(f"unknown cond backend {backend!r}")
