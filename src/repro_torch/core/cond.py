"""``cond(pred, true_fn, false_fn)`` (paper §2.1, compiled per §4.2).

Three lowerings; which one decides where:

- ``backend="native"``: exactly one branch runs. The predicate is
  brought to the host (a tensor is read once), which is the eager
  counterpart of ``lax.cond`` on one device.
- ``backend="graph"``: the device form of ``native``, for a body that
  ``while_loop(..., impl="graph")`` is capturing (``core.device_loop``):
  the cond becomes two CUDA-graph IF nodes on the predicate and its
  negation, so exactly one branch runs and the decision never leaves the
  device. The predicate must be a one-element CUDA tensor; leaves that
  both branches return as the same object pass through (in-place
  branches), otherwise the false branch's result is copied into the true
  branch's. Under grad, in the body of a differentiated
  ``while_loop(impl="graph")`` (``core.device_grad``), each branch runs
  on detached operands into a tape of its own and writes its results
  into buffers made by the branch that runs first; the gradient is two
  IF nodes on the same predicate (pushed under ``save_policy``
  "all"/"offload", recomputed under "carry"/"carry_offload"), each
  writing the operands' cotangents, zero where the untaken branch would
  have given some. Refused: under grad outside such a body, and a branch
  that reads or writes the loop's ``DeviceTensorArray`` or reaches a
  tensor computed before the cond that is not an operand. Outside a
  graph loop's body it raises.
- ``backend="select"``: both branches run and ``torch.where`` keeps the
  taken one, the masked form of the paper's deadness (§4.4) that the
  JAX package uses inside partitioned stages. The predicate stays on
  the device: no host read.

``native`` and ``select`` are differentiable by autograd: the native
path records only the taken branch (the paper's §5.1 rule, the gradient
of a cond is a cond on the same predicate), the select path
differentiates as a select.
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
    if backend == "graph":
        from .device_loop import graph_cond
        return graph_cond(pred, true_fn, false_fn, operands)
    if backend == "select":
        t_out = true_fn(*operands)
        f_out = false_fn(*operands)

        def select(t, f):
            t, f = torch.as_tensor(t), torch.as_tensor(f)
            p = torch.as_tensor(pred, device=t.device)
            return torch.where(p, t, f)

        return pytree.tree_map(select, t_out, f_out)
    raise ValueError(f"unknown cond backend {backend!r}")
