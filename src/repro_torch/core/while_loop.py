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

- ``impl="host"`` (the default; the only one on the CPU, where the tape
  records the four §5.3 policies above): an eager Python loop that
  brings the decision to the host once per iteration. The
  iteration counter and ``max_iters`` are Python ints, so the clamp costs
  nothing; a predicate that ``cond_fn`` returns as a tensor (a
  data-dependent one, such as ``dynamic_rnn``'s ``t < max(lens)``) is
  read to the host, and each read is counted in
  ``while_loop.host_reads``. A vector predicate keeps the loop alive
  while ANY element holds, as in JAX. A predicate returned as a Python
  bool costs no read.
- ``impl="graph"`` (CUDA tensors): without grad, ``core.device_loop``
  captures the loop once as a CUDA graph whose WHILE node re-evaluates
  the predicate on the device, and replays it: one graph launch per
  call, no host read (``DeviceLoop.replays``). The carry must be static
  CUDA tensors (a counter too: no Python numbers), updated in place; a
  ``cond(..., backend="graph")`` inside the body becomes an IF node, and
  a ``while_loop(impl="graph")`` inside it a nested WHILE node of the
  same graph (on a copy of its initial carry, returned).
  The loop captured for a ``(cond_fn, body_fn)`` pair and its carry's
  objects is replayed by every later call with the same ones, while
  those functions live; a caller that replays one loop throughout (the
  serving scheduler) holds its ``device_loop.DeviceLoop`` instead.
  Under grad with a tensor that requires it (in the carry or among the
  tensors ``body_fn``/``cond_fn`` close over), and for a carry that
  holds a ``DeviceTensorArray``, the loop goes through
  ``core.device_grad``: §5.1's forward and gradient loops as two WHILE
  nodes under all four policies, on contiguous stacks: "all" pushes the
  body's residuals (the tensors autograd saves) on the device and the
  gradient loop differentiates the recorded body without re-running it,
  "offload" keeps those stacks in pinned host memory, "carry" pushes the
  carry and re-runs the body, "carry_offload" keeps the carry in pinned
  host memory. The closed-over tensors are lifted out as constants, the
  pair is captured once per program and replayed by later calls, and it
  returns fresh tensors. A ``cond(backend="graph")`` in such a body is
  differentiated as §5.1 says, by a cond on the same predicate (pushed
  under "all"/"offload", recomputed under "carry"), and a graph loop
  nested in it, under grad, is a nested forward and gradient loop when
  the outer loop's policy is "carry" or "carry_offload" (which re-run
  the outer body); under an outer "all"/"offload" it is refused.

``parallel_iterations``, the paper's §4.3 knob for how many iterations
may be in flight, has the JAX package's meaning: on a counted loop
(``cond_fn=None``) under ``save_policy="all"`` it is the unroll window,
the number of body copies one loop step runs (``lax.scan(unroll=)``
there), with a remainder step when the window does not divide the trip
count. With ``mesh=`` carrying a pipeline "stage" axis the window is
widened to at least one full stage rotation
(``dist.pipeline.schedule_unroll``). Under ``impl="graph"`` a window of
``w`` makes ``n // w`` WHILE-node iterations of ``w`` copies, and a
remainder step of the other ``n % w`` copies after the WHILE node, in
the same graph; under ``impl="host"`` it makes ``ceil(n / w)`` loop
steps, each one bound check (``while_loop.steps`` counts them). Results do not change. The
stack-saving policies run the loop rolled, as in the JAX package.

``offload_shardings`` (a tree matching ``init`` of DTensor placement
tuples, or None leaves) must match the placements of the carry's
DTensors; the host stack then keeps each rank's local shard
(``core.stacks``).
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


def _is_placements(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _check_offload_shardings(init, offload_shardings, name) -> None:
    """Each placement tuple of ``offload_shardings`` must be the
    placements of the carry leaf at its place (a plain tensor may only
    be replicated)."""
    if offload_shardings is None:
        return
    from torch.distributed.tensor import DTensor, Replicate
    want = pytree.tree_leaves(
        offload_shardings, is_leaf=lambda x: x is None or _is_placements(x))
    leaves = pytree.tree_leaves(init, is_leaf=_is_ta)
    if len(want) != len(leaves) or not all(
            w is None or _is_placements(w) for w in want):
        raise ValueError(
            f"while_loop({name!r}): offload_shardings must be a tree like "
            f"init with a placements tuple (or None) per leaf")
    for leaf, w in zip(leaves, want):
        if w is None:
            continue
        have = (tuple(leaf.placements) if isinstance(leaf, DTensor) else
                (Replicate(),) * len(w))
        if have != tuple(w):
            raise ValueError(
                f"while_loop({name!r}): offload_shardings gives {tuple(w)} "
                f"for a carry leaf placed as {have}")


def _window(cond_fn, save_policy, parallel_iterations, mesh,
            max_iters) -> int:
    """Body copies per loop step: ``parallel_iterations`` on a counted
    loop under "all" (widened to a stage rotation on a stage mesh),
    else 1."""
    if cond_fn is not None or save_policy != "all":
        return 1
    window = parallel_iterations
    if mesh is not None and parallel_iterations > 1:
        from ..dist import pipeline
        window = pipeline.schedule_unroll(mesh, parallel_iterations)
    return max(1, min(int(window), max_iters))


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
    under both lowerings and every save policy.

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
      parallel_iterations: the unroll window of a counted loop under
        "all" (§4.3; see the module docstring); no effect on results.
      offload_shardings: a tree like ``init`` of DTensor placement
        tuples (or None), checked against the carry's DTensors.
      mesh: the device mesh the loop runs under (a ``DeviceMesh`` or a
        name -> size mapping); a "stage" axis widens the window.
      name: frame name, for error messages.
      impl: "host" (eager, predicate read on the host) or "graph" (CUDA
        graph, decided on the device; see the module docstring).
      prologue: carry -> None, called once before the first predicate
        (captured into the same launch under ``impl="graph"``).

    Returns:
      The final carry. ``while_loop.host_reads`` counts the predicate
      reads and ``while_loop.steps`` the host lowering's loop steps;
      ``while_loop.last_stack`` is the save-stack of the last call that
      recorded a gradient (its ``saved_bytes`` and ``host_bytes``),
      else None; ``while_loop.last_loop`` is the ``DeviceLoop`` of the
      last plain ``impl="graph"`` call and ``while_loop.last_grad_loop``
      the ``device_grad.GradLoop`` of the last one through
      ``core.device_grad``.
    """
    if save_policy not in SAVE_POLICIES:
        raise ValueError(f"unknown save_policy {save_policy!r}")
    if cond_fn is None and max_iters is None:
        raise ValueError("counted loop (cond_fn=None) requires max_iters")
    _check_offload_shardings(init, offload_shardings, name)
    window = _window(cond_fn, save_policy, parallel_iterations, mesh,
                     max_iters)
    if impl == "graph":
        from . import device_grad, device_loop
        if device_loop.drive_mode() is not None:
            # nested in a loop body that a graph loop drives
            return device_grad.nested(
                cond_fn, body_fn, init, max_iters=max_iters,
                save_policy=save_policy, prologue=prologue, name=name,
                unroll=window)
        lifted = device_grad.takes(init, body_fn, cond_fn)
        if lifted is not None:
            out, while_loop.last_grad_loop = device_grad.run(
                lifted, cond_fn is not None, init, max_iters=max_iters,
                save_policy=save_policy, name=name, prologue=prologue)
            return out
        while_loop.last_loop = device_loop.run(
            cond_fn, body_fn, init, max_iters=max_iters, prologue=prologue,
            name=name, unroll=window)
        return init
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
        while_loop.steps += 1
        if window > 1:          # a counted loop under "all"
            for _ in range(min(window, max_iters - i) - 1):
                if stack is None:
                    carry = body_fn(carry)
                else:
                    with stack.hooks():
                        carry = body_fn(carry)
                    stack.next_iteration()
                i += 1
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
while_loop.steps = 0
while_loop.last_stack = None
while_loop.last_loop = None
while_loop.last_grad_loop = None


def fori_loop(lower, upper: int, body_fn: Callable, init: Any, *,
              save_policy: str = "all", parallel_iterations: int = 1,
              offload_shardings: Any = None, mesh: Any = None) -> Any:
    """Counted loop ``for i in [lower, upper): carry = body_fn(i, carry)``;
    ``i`` is a Python int."""
    n = int(upper) - int(lower)

    def body(carry):
        i, c = carry
        return (i + 1, body_fn(i, c))

    if offload_shardings is not None:
        offload_shardings = (None, offload_shardings)
    _, out = while_loop(None, body, (int(lower), init), max_iters=max(n, 0),
                        save_policy=save_policy,
                        parallel_iterations=parallel_iterations,
                        offload_shardings=offload_shardings, mesh=mesh)
    return out
