"""``while_loop`` with reverse-mode automatic differentiation (paper §5.1).

The JAX package builds the paper's construction by hand around
``lax.while_loop``: a ``custom_vjp`` whose forward pushes the body's
residuals onto bounded stacks and whose backward is a second loop that
runs the body's VJP in reverse, popping them, with the gradients of
captured constants summed across iterations (``jax.closure_convert``).

Eager PyTorch already records that construction: the loop runs as a
Python loop, autograd's tape is the save-stack (every tensor an op
saves is a push, its unpack in the backward a pop), the backward walks
the iterations in reverse, and a tensor the body captures (a
parameter) is a leaf of the tape whose gradient autograd sums over
every iteration that used it. The §5.3 memory policies are applied to
that tape:

- ``"all"``: the body's saved tensors stay on the device (TF's
  default; no recomputation);
- ``"offload"``: the same tensors go to pinned host memory, pushed on a
  side stream and prefetched one iteration ahead of the backward (the
  paper's GPU→CPU swapping, native on a CUDA card);
- ``"carry"``: each iteration's body runs under
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so
  only the loop carry is saved and the backward re-runs the body once
  per iteration (recompute-instead-of-save, Gruslys et al. / Chen et
  al.);
- ``"carry_offload"``: ``"carry"``, with the saved carry in host memory
  (the paper's Table 1 configuration, swap + recompute).

``core.stacks.SaveStack`` implements the stacks as
``saved_tensors_hooks``. The primal path (grad mode off, or no tensor
requiring grad) records nothing and so pushes nothing, as in JAX.

The predicate, and which lowering decides where. The JAX loop decides
in-graph. This port has two lowerings, chosen by ``impl``:

- ``impl="host"`` (the default; the only one on the CPU and the only one
  that records gradients, with the §5.3 policies above): an eager Python
  loop that brings the decision to the host once per iteration. The
  iteration counter and ``max_iters`` are Python ints, so the clamp costs
  nothing; a predicate that ``cond_fn`` returns as a tensor (a
  data-dependent one, such as ``dynamic_rnn``'s ``t < max(lens)``) is
  read to the host, and each read is counted in
  ``while_loop.host_reads``. A vector predicate keeps the loop alive
  while ANY element holds, as in JAX. A predicate returned as a Python
  bool costs no read.
- ``impl="graph"`` (CUDA tensors, no grad mode): ``core.device_loop``
  captures the loop once as a CUDA graph whose WHILE node re-evaluates
  the predicate on the device, and replays it: one graph launch per
  call, no host read (``DeviceLoop.replays``). The carry must be static
  CUDA tensors (a counter too: no Python numbers), updated in place; a
  ``cond(..., backend="graph")`` inside the body becomes an IF node.
  The loop captured for a ``(cond_fn, body_fn)`` pair and its carry's
  objects is replayed by every later call with the same ones, while
  those functions live; a caller that replays one loop throughout (the
  serving scheduler) holds its ``device_loop.DeviceLoop`` instead.

``parallel_iterations`` is accepted for the JAX signature and has no
effect on results; in the JAX package it is only an unroll factor. The
distributed arguments (``mesh``, ``offload_shardings``) belong to the
multi-device ``dist`` slice of ROADMAP.md and are refused here.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from .stacks import SaveStack
from .tensor_array import TensorArray

__all__ = ["while_loop", "fori_loop", "SAVE_POLICIES"]

SAVE_POLICIES = ("all", "offload", "carry", "carry_offload")


def _is_ta(x) -> bool:
    return isinstance(x, TensorArray)


def _needs_grad(leaves) -> bool:
    return any((torch.is_tensor(x) or _is_ta(x)) and x.requires_grad
               for x in leaves)


def _holds(pred) -> bool:
    """Bring a predicate to the host: a tensor is read (and counted), a
    vector one holds while any element does."""
    if torch.is_tensor(pred):
        while_loop.host_reads += 1
        return bool(pred.any()) if pred.dim() else bool(pred)
    return bool(pred)


def _refuse_dist(mesh, offload_shardings) -> None:
    if mesh is not None or offload_shardings is not None:
        raise NotImplementedError(
            "while_loop: mesh= and offload_shardings= are multi-device; "
            "they belong to the dist slice of ROADMAP.md (this port runs "
            "on one card)")


def while_loop(cond_fn: Optional[Callable], body_fn: Callable, init: Any, *,
               max_iters: Optional[int] = None,
               save_policy: str = "all",
               parallel_iterations: int = 1,
               offload_shardings: Any = None,
               mesh: Any = None,
               name: str = "while",
               impl: str = "host",
               prologue: Optional[Callable] = None) -> Any:
    """Run ``body_fn`` while ``cond_fn`` holds; reverse-differentiable
    under ``impl="host"``.

    Args:
      cond_fn: carry -> bool (a Python bool, or a tensor read to the
        host; a non-scalar tensor keeps the loop alive while ANY element
        holds). ``None`` means a counted loop of exactly ``max_iters``
        iterations.
      body_fn: carry -> carry (any pytree; TensorArrays welcome).
      init: initial carry.
      max_iters: bound on the trip count; required for reverse-mode AD
        (it bounds the save-stacks, paper §5.1) and for counted loops.
      save_policy: "all" | "offload" | "carry" | "carry_offload".
      parallel_iterations: accepted; no effect on results.
      offload_shardings, mesh: refused (multi-device; ROADMAP.md dist).
      name: frame name, for error messages.
      impl: "host" (eager, predicate read on the host) or "graph" (CUDA
        graph, decided on the device; see the module docstring).
      prologue: carry -> None, called once before the first predicate
        (captured into the same launch under ``impl="graph"``).

    Returns:
      The final carry. ``while_loop.host_reads`` counts the predicate
      reads; ``while_loop.last_stack`` is the save-stack of the last
      call that recorded a gradient (its ``saved_bytes`` and
      ``host_bytes``), else None.
    """
    if save_policy not in SAVE_POLICIES:
        raise ValueError(f"unknown save_policy {save_policy!r}")
    _refuse_dist(mesh, offload_shardings)
    if cond_fn is None and max_iters is None:
        raise ValueError("counted loop (cond_fn=None) requires max_iters")
    if impl == "graph":
        from . import device_loop
        return device_loop.run(cond_fn, body_fn, init, max_iters=max_iters,
                               prologue=prologue, name=name)
    if impl != "host":
        raise ValueError(f"unknown while_loop impl {impl!r}")
    if prologue is not None:
        prologue(init)

    recompute = save_policy in ("carry", "carry_offload")
    stack = None
    if torch.is_grad_enabled():
        stack = SaveStack(offload=save_policy in ("offload",
                                                  "carry_offload"))
    while_loop.last_stack = None

    def check_bound(leaves):
        if max_iters is None and stack is not None and _needs_grad(leaves):
            raise ValueError(
                f"while_loop({name!r}): reverse-mode AD requires max_iters "
                "to bound the save-stacks (paper §5.1)")

    carry = init
    leaves, spec = pytree.tree_flatten(carry, is_leaf=_is_ta)
    check_bound(leaves)
    i = 0
    while (max_iters is None or i < max_iters) and \
            (cond_fn is None or _holds(cond_fn(carry))):
        if stack is None:
            carry = body_fn(carry)
        elif recompute and _needs_grad(leaves):
            tensor_ix = [k for k, x in enumerate(leaves) if torch.is_tensor(x)]

            def run(*tensors, _leaves=leaves, _spec=spec, _ix=tensor_ix):
                full = list(_leaves)
                for k, t in zip(_ix, tensors):
                    full[k] = t
                return body_fn(pytree.tree_unflatten(full, _spec))

            with stack.hooks():
                carry = checkpoint(run, *[leaves[k] for k in tensor_ix],
                                   use_reentrant=False)
            stack.next_iteration()
        else:
            with stack.hooks():
                carry = body_fn(carry)
            stack.next_iteration()
        i += 1
        leaves, spec = pytree.tree_flatten(carry, is_leaf=_is_ta)
        check_bound(leaves)
    if stack is not None and stack.saved_bytes:
        while_loop.last_stack = stack
    return carry


while_loop.host_reads = 0
while_loop.last_stack = None


def fori_loop(lower, upper: int, body_fn: Callable, init: Any, *,
              save_policy: str = "all", parallel_iterations: int = 1,
              offload_shardings: Any = None, mesh: Any = None) -> Any:
    """Counted loop ``for i in [lower, upper): carry = body_fn(i, carry)``;
    ``i`` is a Python int."""
    _refuse_dist(mesh, offload_shardings)
    n = int(upper) - int(lower)

    def body(carry):
        i, c = carry
        return (i + 1, body_fn(i, c))

    _, out = while_loop(None, body, (int(lower), init), max_iters=max(n, 0),
                        save_policy=save_policy,
                        parallel_iterations=parallel_iterations)
    return out
