"""§5.1 on the device: a while loop's forward and its gradient loop as two
CUDA-graph WHILE nodes (the graph lowering of ``while_loop`` under grad).

The JAX package's ``core.while_loop`` is a ``custom_vjp``: the forward
loop pushes onto bounded contiguous stacks either the body's VJP
residuals (``all``, ``offload``) or the carry (``carry``,
``carry_offload``), and the gradient is a second loop that pops them in
reverse, rebuilds the body's VJP from the popped residuals or re-runs
the body from the popped carry, and sums the gradients of the constants
the body captures (``jax.closure_convert``); XLA compiles both into the
program and the loops never return to the host. Here:

- ``GradLoop`` is one loop for one program (the code of ``body_fn`` and
  ``cond_fn``, the shapes and dtypes of the carry and of the constants,
  the policy): its static carry, its constants' static buffers, its
  stacks and two ``DeviceLoop``s on one stream. After the forward the
  device counter ``it`` is the trip count ``n``; the gradient loop runs
  while ``j < n`` and pops row ``n-1-j``. The carry's cotangent is its
  carry, and the constants' gradients are summed into static
  accumulators.
- ``all`` and ``offload``: the forward body runs ``body_fn`` under
  ``enable_grad`` and the hooks of ``core.stacks.ResidualStacks``, which
  push each distinct tensor autograd saves onto its own ``CarryStack``
  (device memory, or pinned host memory through ``graph_loop.cu``'s
  ``stack_copy``) at row ``it``, and the array indices the body read
  and wrote at. The graph recorded while the loop is built (the eager
  warm-up on the CPU, the capture on the card) is the template, the
  JAX package's ``res_holder["tree"]``: the gradient body pops every
  stack and calls ``torch.autograd.grad(..., retain_graph=True)`` on the
  template, whose unpack hooks return the popped values, captured as
  ``make_graphed_callables`` captures a backward. It makes no call of
  ``body_fn``. Views of the constants' static buffers are not pushed
  but re-viewed; the carry's are pushed, since the next iteration
  overwrites them. A body must save the same tensors every iteration,
  and a custom ``autograd.Function`` that keeps a tensor on ``ctx``
  outside ``save_for_backward`` is refused (the template would replay
  its one value).
- ``carry`` and ``carry_offload``: the forward pushes the carry and
  runs the body; the gradient body pops the carry, re-runs the body
  under ``enable_grad`` and calls ``torch.autograd.grad`` on it.
- A ``DeviceTensorArray`` in the carry is not pushed (its written rows
  stay alive); in the gradient (and, under ``all``/``offload``, the
  recording forward) body every array is a dual view whose duals are
  one-row operations (``tensor_array``).
- Constants, the counterpart of ``jax.closure_convert``: the tensors and
  arrays that ``body_fn``/``cond_fn`` close over (closure cells,
  ``functools.partial`` arguments, default arguments, walked through
  lists, tuples, dicts and nested functions) are lifted out, and the
  functions rebuilt to close over the loop's static copies. The eager
  warm-up's graph must reach no tensor that requires grad outside the
  carry and those constants (a global, an object's attribute, a result
  computed before the loop); if it does, the loop refuses with an error
  that names it, never a silent zero gradient.
- Reuse, the jit cache's counterpart: a later call with the same
  program replays the captured pair. Inputs, lengths and weights are
  copied into the static buffers (an optimizer hands back new tensors
  every step); returned outputs and gradients are fresh tensors. A call
  made while a loop's stacks still wait for their backward takes
  another loop (captured once too).
- ``_Loop`` is the ``torch.autograd.Function``: forward = one launch of
  the forward graph, backward = one launch of the gradient graph.
- Conds and nested loops (§5.1: "the gradient of a cond is a cond on
  the same predicate", an inner loop's gradient an inner loop). Under
  grad a body records a tape of events: a ``cond(backend="graph")``
  runs each branch on detached operands into a tape of its own and
  writes its results into buffers that become leaves
  (``cond_on_tape``); a ``while_loop(impl="graph")`` in the body, when
  the outer loop re-runs its body (``carry``, ``carry_offload``), is a
  nested ``GradLoop`` whose forward and gradient loops are WHILE nodes
  of that body and whose stacks its prologue resets each outer
  iteration (``nested``). The gradient body walks the events in
  reverse (``_backprop``), one ``torch.autograd.grad`` call per segment
  on the capturing thread: a cond's gradient is two IF nodes on its
  predicate (pushed by value under ``all``/``offload``, each branch's
  residuals pushed in its own IF node as a group of
  ``ResidualStacks``; recomputed under ``carry``), writing the operands'
  cotangents into shared buffers, zero from the untaken branch. An
  inner loop under grad in an outer ``all``/``offload`` body is refused
  (its stacks would need rows indexed by both counters).

Without grad (or with nothing that requires it) the forward is the
plain WHILE loop, with no stack. ``plain_driver()`` runs the same
bodies, stacks, hooks, template, duals and events under a step-by-step
Python loop instead of the graphs, each cond decided on the host (it
takes every ``while_loop(impl="graph")``, CPU tensors too): the CPU
tests' driver; nothing on the card's path uses it. Before its capture
a loop runs its bodies once eagerly with both branches of every cond
(``device_loop.frame("warm")``), so that both initialise, record their
stacks and are checked.

``GradLoop.captures``, ``.replays`` (graph launches, forward and
gradient) and ``.host_reads`` (the double-write check after a forward
over a carry array) count in this process; ``.residual_bytes``,
``.carry_bytes`` and ``.host_bytes`` give what one iteration pushes and
the pinned host memory of the stacks.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import types
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from . import device_loop
from .device_loop import drive_mode, frame
from .stacks import CarryStack, ResidualStacks, recording_residuals
from .tensor_array import (DeviceTensorArray, TensorArray, WriteOnceError,
                           _row, deferred_checks)

__all__ = ["GradLoop", "active_tape", "cond_on_tape", "nested",
           "plain_driver", "release", "run", "takes"]

GRAPH_POLICIES = ("all", "offload", "carry", "carry_offload")
_PLAIN = [0]


@contextlib.contextmanager
def plain_driver():
    """Run graph-lowered loops through the step-by-step driver (CPU
    tensors allowed): the same bodies, stacks and duals, no graph."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


def _is_dta(x) -> bool:
    return isinstance(x, DeviceTensorArray)


def _flatten(tree):
    return pytree.tree_flatten(tree, is_leaf=_is_dta)


def _parts(x) -> List[torch.Tensor]:
    return x.tensors() if _is_dta(x) else [x]


def _regroup(flat, is_array) -> List[Any]:
    """Tensors back into leaves: three for a ``DeviceTensorArray``."""
    out, at = [], 0
    for ta in is_array:
        k = 3 if ta else 1
        out.append(DeviceTensorArray(*flat[at:at + k]) if ta else flat[at])
        at += k
    return out


def _sig(x) -> tuple:
    t = x.data if _is_dta(x) else x
    return ("TA" if _is_dta(x) else "T", tuple(t.shape), t.dtype,
            t.device, t.requires_grad)


# ------------------------------------------------------- closure convert

class _Lifted:
    """Functions with their tensors and device arrays lifted out:
    ``consts`` in first-seen order (one entry per object), ``key`` the
    structure, ``make(i, values)`` function ``i`` closing over
    ``values``."""

    def __init__(self, fns):
        self.consts: List[Any] = []
        self._index: Dict[int, int] = {}
        self._active: set = set()
        lifted = [self._lift(f) for f in fns]
        self.key = tuple(k for k, _ in lifted)
        self._make = [r for _, r in lifted]

    def make(self, i: int, values):
        return self._make[i](values)

    def _lift(self, obj) -> Tuple[Any, Callable]:
        if torch.is_tensor(obj) or _is_dta(obj):
            i = self._index.get(id(obj))
            if i is None:
                i = self._index[id(obj)] = len(self.consts)
                self.consts.append(obj)
            return ("const", i), lambda v, i=i: v[i]
        if isinstance(obj, TensorArray):
            raise TypeError("the graph lowering reads a DeviceTensorArray; "
                            "the body captures a host-indexed TensorArray")
        if isinstance(obj, functools.partial):
            (kf, rf), (ka, ra), (kk, rk) = (
                self._lift(obj.func), self._lift(obj.args),
                self._lift(obj.keywords))
            return (("partial", kf, ka, kk),
                    lambda v: functools.partial(rf(v), *ra(v), **rk(v)))
        if isinstance(obj, types.FunctionType):
            return self._lift_fn(obj)
        if type(obj) in (list, tuple):
            parts = [self._lift(x) for x in obj]
            kind = type(obj)
            return ((kind.__name__, tuple(k for k, _ in parts)),
                    lambda v: kind(r(v) for _, r in parts))
        if type(obj) is dict:
            parts = [(k, self._lift(x)) for k, x in obj.items()]
            return (("dict", tuple((k, kk) for k, (kk, _) in parts)),
                    lambda v: {k: r(v) for k, (_, r) in parts})
        try:
            key = ("obj", type(obj), hash(obj), obj)
        except TypeError:
            key = ("id", id(obj))
        return key, lambda v: obj

    def _lift_fn(self, fn):
        cells = fn.__closure__ or ()
        if id(fn) in self._active or fn.__kwdefaults__:
            return ("fn", fn), lambda v: fn
        if not (cells or fn.__defaults__):
            # keyed by its code: a body's lambda is made anew each call
            return (("code", fn.__code__, id(fn.__globals__)),
                    lambda v: fn)
        self._active.add(id(fn))
        try:
            parts = []
            for c in cells:
                try:
                    parts.append(self._lift(c.cell_contents))
                except ValueError:                 # an empty cell
                    parts.append((("empty",), None))
            dk, dr = self._lift(fn.__defaults__ or ())
        finally:
            self._active.discard(id(fn))

        def rebuild(v):
            new = types.FunctionType(
                fn.__code__, fn.__globals__, fn.__name__, dr(v) or None,
                tuple(types.CellType() if r is None else
                      types.CellType(r(v)) for _, r in parts))
            new.__kwdefaults__ = fn.__kwdefaults__
            return new
        return (("closure", fn.__code__, tuple(k for k, _ in parts), dk),
                rebuild)


# --------------------------------------------------------------- drivers

class _PlainLoop:
    """``DeviceLoop``'s contract (static carry, outputs copied into its
    leaves, ``run``/``iterations``/``close``) as a Python loop, its
    conds decided on the host."""

    def __init__(self, cond_fn, body_fn, carry, *, max_iters, prologue,
                 name):
        self.cond_fn, self.body_fn, self.carry = cond_fn, body_fn, carry
        self.max_iters, self.prologue, self.name = max_iters, prologue, name
        self._n = 0

    def run(self):
        with frame("host", on_card=False):
            self._n = device_loop.eager_loop(
                self.cond_fn, self.body_fn, self.carry,
                max_iters=self.max_iters, prologue=self.prologue,
                name=self.name)
        return self.carry

    def iterations(self) -> int:
        return self._n

    def close(self):
        self.carry = None


class _NestedLoop(_PlainLoop):
    """A loop of a ``GradLoop`` nested in another loop's body: recorded
    as a WHILE node of the body being captured, or run step by step as
    the enclosing body is driven (the warm-up, the plain driver).
    ``before`` runs first."""

    def __init__(self, *args, before=None, **kw):
        super().__init__(*args, **kw)
        self.before = before

    def run(self):
        if self.before is not None:
            self.before()
        if drive_mode() == "capture":
            device_loop.record_loop(self.cond_fn, self.body_fn, self.carry,
                                    max_iters=self.max_iters,
                                    prologue=self.prologue, name=self.name)
        else:
            self._n = device_loop.eager_loop(
                self.cond_fn, self.body_fn, self.carry,
                max_iters=self.max_iters, prologue=self.prologue,
                name=self.name)
        return self.carry


class _Token:
    """Owns a loop from its forward to its backward (weakly held)."""


def _static(x, grad: bool):
    """A loop's static copy of a carry leaf or a constant."""
    if _is_dta(x):
        return x.empty_like()
    s = torch.empty_like(x, memory_format=torch.contiguous_format)
    return s.requires_grad_() if grad and x.requires_grad else s


def _load(static, value) -> None:
    with torch.no_grad():
        for s, v in zip(_parts(static), _parts(value)):
            s.copy_(v)


def _nodes(outputs):
    """Each backward node that reaches ``outputs``, once. The walk holds
    every node it met: a node's Python object lives only while
    referenced, and a later one could take a freed one's id."""
    seen, todo = {}, [o.grad_fn for o in outputs]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        yield node
        todo.extend(n for n, _ in node.next_functions)


def _uncovered(outputs, allowed, seq0: int, what: str) -> None:
    """Refuse a gradient body whose graph reaches a tensor that requires
    grad other than ``allowed`` (its graph's inputs)."""
    ids = {id(x) for x in allowed}
    for node in _nodes(outputs):
        var = getattr(node, "variable", None)
        if var is not None:                      # AccumulateGrad: a leaf
            if id(var) not in ids:
                raise ValueError(
                    f"{what}: the body reaches a {tuple(var.shape)} "
                    f"{var.dtype} tensor that requires grad and lies "
                    f"outside the carry and the tensors body_fn/cond_fn "
                    f"close over (a global or an object's attribute); its "
                    f"gradient would be silently zero. Close over it or "
                    f"pass it in the carry")
        elif node._sequence_nr() < seq0:
            raise ValueError(
                f"{what}: the body reaches {node.name()}, a result computed "
                f"before the loop that requires grad, through a tensor "
                f"that is neither in the carry nor closed over by "
                f"body_fn/cond_fn; its gradient would be silently zero. "
                f"Close over it or pass it in the carry")


def _sequence_now() -> int:
    with torch.enable_grad():
        probe = torch.zeros((), requires_grad=True) * 1
    return probe.grad_fn._sequence_nr()


def _hidden(outputs, what: str) -> None:
    """Refuse a recorded body graph with a node whose state escapes the
    residual hooks: a custom ``autograd.Function`` that keeps a tensor
    (or a graph loop) on ``ctx`` instead of ``save_for_backward``. Its
    backward would read the recording's value in every iteration."""
    def holds(v) -> bool:
        if torch.is_tensor(v) or isinstance(v, GradLoop):
            return True
        if isinstance(v, (list, tuple)):
            return any(holds(x) for x in v)
        return isinstance(v, dict) and any(holds(x) for x in v.values())

    for node in _nodes(outputs):
        if isinstance(node, torch.autograd.function.BackwardCFunction):
            bad = [k for k, v in vars(node).items() if holds(v)]
            if bad:
                raise ValueError(
                    f"{what}: {node.name()} keeps ctx.{bad[0]} outside "
                    f"save_for_backward; save_policy 'all'/'offload' replay "
                    f"one recorded graph, whose backward would read that "
                    f"value in every iteration. Save it with "
                    f"ctx.save_for_backward, or use save_policy 'carry'")


class _Template:
    """The forward body's graph recorded while the loop was built (the
    JAX package's ``res_holder["tree"]``): its carry inputs, flattened
    outputs, array reads ``(dual grad, index, leaf)`` and writes ``(dual
    grad, index, value)``, an index being a Python int or a residual's
    handle; ``seq0`` the autograd sequence number before it; ``tape``
    its events."""

    __slots__ = ("xs", "out", "reads", "writes", "seq0", "tape")

    def __init__(self, xs, out, reads, writes, seq0, tape):
        self.xs, self.out, self.reads, self.writes = xs, out, reads, writes
        self.seq0, self.tape = seq0, tape


# ------------------------------------------------------------- the tapes
#
# Under grad a loop body is a sequence of autograd segments cut at its
# conds and at the loops nested in it (the events). Each event's outputs
# are fresh leaves, so the body's graph stops at them; ``_backprop``
# walks the events in reverse, each a call of ``torch.autograd.grad`` on
# the capturing thread (every capture split happens there, none in an
# autograd-engine callback): ``jax.custom_vjp``'s composition by hand.

_LOCAL = threading.local()     # .tapes: this thread's, innermost last


def _tapes() -> List["_Tape"]:
    if not hasattr(_LOCAL, "tapes"):
        _LOCAL.tapes = []
    return _LOCAL.tapes


class _Tape:
    """The events a body, or a branch of a cond in it, records under
    grad, in order. ``owner`` is the ``GradLoop`` whose body runs (its
    nested loops are cached on it), ``res`` its residual stacks while
    its forward records them (None otherwise), ``path`` the tape's place
    (the residual group of its saves), ``views`` the loop's dual
    arrays."""

    __slots__ = ("owner", "res", "path", "views", "events", "loops")

    def __init__(self, owner, res, path, views):
        self.owner, self.res, self.path, self.views = owner, res, path, views
        self.events: List[Any] = []
        self.loops = 0              # nested loops met so far


def active_tape() -> Optional[_Tape]:
    """The tape of the differentiated body now running, if any."""
    tapes = _tapes()
    return tapes[-1] if tapes else None


@contextlib.contextmanager
def _taping(tape: _Tape):
    _tapes().append(tape)
    try:
        if tape.res is not None:
            with tape.res.in_group(tape.path):
                yield tape
        else:
            yield tape
    finally:
        _tapes().pop()


class _Ctx:
    """What a gradient iteration's events need: the residual stacks (or
    None: the body was re-run), the popped row ``k``, whether to run the
    checks of the warm-up, and the loop's name for errors."""

    __slots__ = ("res", "k", "check", "what")

    def __init__(self, res, k, check, what):
        self.res, self.k, self.check, self.what = res, k, check, what


class _Acc:
    """Cotangents summed by tensor (the tensor held, so its id stays
    its own)."""

    def __init__(self):
        self._g: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def add(self, t, g) -> None:
        if g is None:
            return
        have = self._g.get(id(t))
        self._g[id(t)] = (t, g if have is None else have[1] + g)

    def get(self, t) -> Optional[torch.Tensor]:
        have = self._g.get(id(t))
        return None if have is None else have[1]


def _differentiable(t) -> bool:
    return torch.is_tensor(t) and t.requires_grad


def _grad_into(acc: _Acc, outputs, gouts, targets, ctx: _Ctx, seq0: int,
               retain: bool) -> None:
    """``torch.autograd.grad`` of one segment, summed into ``acc``."""
    if ctx.check:
        ids = {id(t) for t in targets}
        for o in outputs:
            if o.grad_fn is None and id(o) not in ids:
                raise ValueError(
                    f"{ctx.what}: the body reaches a {tuple(o.shape)} "
                    f"{o.dtype} tensor that requires grad and lies outside "
                    f"the carry and the tensors body_fn/cond_fn close "
                    f"over; its gradient would be silently zero. Close "
                    f"over it or pass it in the carry")
        _uncovered(outputs, targets, seq0, ctx.what)
        if ctx.res is not None:
            _hidden(outputs, ctx.what)
    if not (outputs and targets):
        return
    with torch.enable_grad():
        grads = torch.autograd.grad(outputs, targets, gouts,
                                    allow_unused=True, retain_graph=retain)
    for t, g in zip(targets, grads):
        acc.add(t, g)


def _backprop(tape: _Tape, outputs, gouts, inputs, ctx: _Ctx,
              seq0: int) -> List[Optional[torch.Tensor]]:
    """The cotangents of ``inputs`` (leaves) from ``gouts``, those of
    ``outputs``: the last segment first, then each event in reverse (its
    gradient, then the segment that made its inputs)."""
    events = tape.events
    made = [[o for o in e.outputs if _differentiable(o)] for e in events]
    retain = ctx.res is not None or bool(events)
    acc = _Acc()
    _grad_into(acc, outputs, gouts,
               list(inputs) + [o for m in made for o in m], ctx, seq0,
               retain)
    for i in range(len(events) - 1, -1, -1):
        e = events[i]
        g_out = [acc.get(o) if _differentiable(o) else None
                 for o in e.outputs]
        if all(g is None for g in g_out):
            continue
        before = list(inputs) + [o for m in made[:i] for o in m]
        g_in, reached = e.backward(g_out, ctx)
        known = {id(t) for t in before}
        for leaf, g in reached:
            if id(leaf) not in known:
                raise ValueError(
                    f"{ctx.what}: a branch of cond(backend='graph') reaches "
                    f"a {tuple(leaf.shape)} {leaf.dtype} tensor that "
                    f"requires grad and is neither an operand, the carry, "
                    f"nor a tensor the loop's functions close over; its "
                    f"gradient would be silently zero. Pass it as an "
                    f"operand")
            acc.add(leaf, g)
        pairs = [(x, g) for x, g in zip(e.inputs, g_in) if g is not None]
        _grad_into(acc, [x for x, _ in pairs], [g for _, g in pairs],
                   before, ctx, seq0, retain)
    return [acc.get(t) for t in inputs]


def _leaves(tensors) -> Dict[int, torch.Tensor]:
    """The leaves that require grad which ``tensors`` reach (themselves
    included)."""
    out = {}
    for t in tensors:
        if t.grad_fn is None and t.requires_grad:
            out[id(t)] = t
    for node in _nodes([t for t in tensors if t.grad_fn is not None]):
        var = getattr(node, "variable", None)
        if var is not None:
            out[id(var)] = var
    return out


class _Branch:
    """One side of a cond as its forward ran: its tape, its outputs (the
    branch's own results, before the copy), the autograd sequence number
    before it."""

    __slots__ = ("tape", "outputs", "seq0")

    def __init__(self, tape, outputs, seq0):
        self.tape, self.outputs, self.seq0 = tape, outputs, seq0

    def reached(self) -> Dict[int, torch.Tensor]:
        """The leaves from outside the branch that its gradient reaches:
        from its outputs, its events' inputs, and what its events'
        branches reach; not its events' outputs."""
        ev = self.tape.events
        out = _leaves([o for o in self.outputs if _differentiable(o)] +
                      [x for e in ev for x in e.inputs])
        for e in ev:
            out.update(e.reached())
        for e in ev:
            for o in e.outputs:
                out.pop(id(o), None)
        return out


class _CondEvent:
    """A cond under grad: the predicate ``p`` (and, under ``all`` and
    ``offload``, its pushed handle), the operands that require grad
    (``inputs``) and the detached leaves both branches run on
    (``leaves``), its two ``_Branch``es (one, under the plain driver)
    and its outputs: buffers made by the branch that ran first and
    written by each, made leaves."""

    def __init__(self, p, handle, inputs, leaves):
        self.p, self.handle = p, handle
        self.inputs, self.leaves = inputs, leaves
        self.sides: List[Optional[_Branch]] = [None, None]
        self.outputs: List[Any] = []
        self._reached: Optional[Dict[int, torch.Tensor]] = None

    def reached(self) -> Dict[int, torch.Tensor]:
        if self._reached is None:
            out = {}
            for side in self.sides:
                if side is not None:
                    out.update(side.reached())
            for leaf in self.leaves:
                out.pop(id(leaf), None)
            self._reached = out
        return self._reached

    def backward(self, g_out, ctx: _Ctx):
        """§5.1: the gradient of a cond is a cond on the same predicate
        (the forward's, popped under ``all``/``offload``). Each side
        writes the cotangents of the operands and of the leaves the
        branches reach into shared buffers, zero where it has none."""
        reached = list(self.reached().values())
        ins = self.leaves + reached
        with torch.no_grad():
            bufs = [torch.zeros_like(t) for t in ins]
        p = self.p if self.handle is None else ctx.res.load(self.handle)

        def side(k):
            def run():
                br = self.sides[k]
                if br is None:
                    raise RuntimeError("cond(backend='graph'): the gradient "
                                       "takes a branch its forward did not "
                                       "record")
                if ctx.res is not None:
                    ctx.res.pop_group(ctx.k, br.tape.path)
                pairs = [(o, g) for o, g in zip(br.outputs, g_out)
                         if g is not None and _differentiable(o)]
                gs = _backprop(br.tape, [o for o, _ in pairs],
                               [g for _, g in pairs], ins, ctx, br.seq0)
                with torch.no_grad():
                    for b, g in zip(bufs, gs):
                        if g is not None:
                            b.copy_(g)
            return run

        device_loop.branches(p, side(0), side(1))
        n = len(self.leaves)
        return bufs[:n], list(zip(reached, bufs[n:]))


def _reads(views) -> int:
    return sum(len(v._dual.reads) + len(v._dual.writes) for v in views)


def cond_on_tape(p: torch.Tensor, true_fn: Callable, false_fn: Callable,
                 operands) -> Any:
    """``cond(backend="graph")`` under grad in a body of this module's
    loops: the branches run on detached leaves of the operands, each
    under ``enable_grad`` into a tape of its own, and write their
    results into buffers with no autograd link; the outputs are those
    buffers as leaves. Under ``all``/``offload`` the predicate is pushed
    (outside the IF nodes) and each branch's residuals are pushed in its
    own IF node."""
    what = "cond(backend='graph')"
    tape = active_tape()
    flat, spec = pytree.tree_flatten(operands)
    inputs, leaves, run_on = [], [], []
    for x in flat:
        if _differentiable(x):
            leaf = x.detach().requires_grad_()
            inputs.append(x)
            leaves.append(leaf)
            x = leaf
        run_on.append(x)
    ops = pytree.tree_unflatten(run_on, spec)
    handle = None if tape.res is None else tape.res.save(p, value=True)
    ev = _CondEvent(p, handle, inputs, leaves)
    index = len(tape.events)
    bufs: List[torch.Tensor] = []
    out_spec: List[Any] = []

    def side(fn, k):
        def run():
            sub = _Tape(tape.owner, tape.res, tape.path + ((index, k),),
                        tape.views)
            n0 = _reads(tape.views)
            seq0 = _sequence_now()
            with _taping(sub), torch.enable_grad():
                out = fn(*ops)
            if _reads(tape.views) != n0:
                raise NotImplementedError(
                    f"{what} under grad: a branch reads or writes a "
                    f"TensorArray of the differentiated loop; read the row "
                    f"before the cond and pass it as an operand")
            leaves_out, s = pytree.tree_flatten(out)
            if out_spec and s != out_spec[0]:
                raise TypeError(f"{what}: the branches return different "
                                f"structures: {out_spec[0]} vs {s}")
            for t in leaves_out:
                if not torch.is_tensor(t):
                    raise TypeError(f"{what} under grad: a branch returns "
                                    f"a {type(t).__name__}; return tensors")
            with torch.no_grad():
                if not out_spec:
                    out_spec.append(s)
                    bufs.extend(torch.empty_like(
                        t, memory_format=torch.contiguous_format)
                        for t in leaves_out)
                for b, t in zip(bufs, leaves_out):
                    if b.shape != t.shape or b.dtype != t.dtype:
                        raise TypeError(
                            f"{what}: the branches return a "
                            f"{tuple(b.shape)} {b.dtype} and a "
                            f"{tuple(t.shape)} {t.dtype} tensor at one "
                            f"place")
                    b.copy_(t)
            ev.sides[k] = _Branch(sub, leaves_out, seq0)
        return run

    device_loop.branches(p, side(true_fn, 0), side(false_fn, 1))
    outs = []
    for i, b in enumerate(bufs):
        grad = b.is_floating_point() and any(
            br is not None and br.outputs[i].requires_grad
            for br in ev.sides)
        outs.append(b.requires_grad_() if grad else b)
    ev.outputs = outs
    tape.events.append(ev)
    return pytree.tree_unflatten(outs, out_spec[0])


class _LoopEvent:
    """A loop nested in a differentiated body: its plan (a nested
    ``GradLoop``), the tensors its cotangents go to (``inputs``: the
    initial carry's and the captured constants' that require grad, each
    with its ``slots`` entry) and its outputs, the final carry's float
    leaves made leaves (an array by its data)."""

    def __init__(self, plan, inputs, slots, outputs, out_slots):
        self.plan, self.inputs, self.slots = plan, inputs, slots
        self.outputs, self.out_slots = outputs, out_slots

    def reached(self) -> Dict[int, torch.Tensor]:
        return {}

    def backward(self, g_out, ctx: _Ctx):
        """The nested gradient loop: pops the inner stacks (reset by the
        inner forward's prologue in this outer iteration) and sums the
        gradients of the inner loop's constants."""
        plan = self.plan
        g_leaves: List[Optional[torch.Tensor]] = [None] * len(plan.carry)
        with torch.no_grad():
            for i, o, g in zip(self.out_slots, self.outputs, g_out):
                g_leaves[i] = torch.zeros_like(o) if g is None else g
            for i in plan._diff_ix:
                if g_leaves[i] is None:
                    g_leaves[i] = torch.zeros_like(plan.carry[i])
            for i, view in plan.carry_duals.items():
                if g_leaves[i] is None and view._dual.grad is not None:
                    g_leaves[i] = torch.zeros_like(view._dual.grad)
        g_carry, g_consts = plan.backward(g_leaves, plan.generation)
        return ([g_carry[i] if kind == "carry" else g_consts[i]
                 for kind, i in self.slots], [])


def nested(cond_fn, body_fn, init, *, max_iters, save_policy, prologue,
           name, unroll) -> Any:
    """``while_loop(impl="graph")`` called in a loop body that a graph
    loop drives. Without grad: ``device_loop.nested_loop``. Under grad
    (in the gradient body of an outer loop under ``carry`` or
    ``carry_offload``, which re-runs the outer body): a nested
    ``GradLoop`` whose forward and gradient loops are WHILE nodes of
    that body, cached on the outer loop; an event of the outer tape."""
    what = f"while_loop({name!r}, impl='graph') nested in a graph loop"
    lifted = takes(init, body_fn, cond_fn)
    leaves, spec = _flatten(init)
    grad = lifted is not None and torch.is_grad_enabled() and any(
        t.requires_grad for x in leaves + lifted.consts
        if torch.is_tensor(x) or _is_dta(x) for t in _parts(x))
    if not grad:
        return device_loop.nested_loop(cond_fn, body_fn, init,
                                       max_iters=max_iters,
                                       prologue=prologue, name=name,
                                       unroll=unroll)
    if prologue is not None:
        raise NotImplementedError(f"{what}: a prologue under grad; its "
                                  f"in-place writes to the carry would not "
                                  f"be differentiated")
    if recording_residuals():
        raise NotImplementedError(
            f"{what}, under grad, in a body whose residuals are recorded "
            f"(the outer loop's save_policy 'all'/'offload'): its stacks "
            f"would need rows indexed by the outer and the inner "
            f"iteration. Give the outer loop save_policy 'carry' or "
            f"'carry_offload', which re-runs the outer body, and the inner "
            f"loop's forward and gradient with it")
    tape = active_tape()
    if tape is None:
        raise RuntimeError(f"{what}: under grad it runs only inside the "
                           f"body of a differentiated while_loop("
                           f"impl='graph')")
    if max_iters is None:
        raise ValueError(f"{what}: the graph lowering under grad needs "
                         f"max_iters (it bounds the stacks, paper §5.1)")
    for x in leaves:
        if not (torch.is_tensor(x) or _is_dta(x)):
            raise TypeError(f"{what}: a carry leaf of type "
                            f"{type(x).__name__}; the gradient-capable "
                            f"graph loop takes tensors and "
                            f"DeviceTensorArrays")
    for c in lifted.consts:
        if _is_dta(c) and c._dual is not None:
            raise NotImplementedError(
                f"{what}: its body closes over a TensorArray of the outer "
                f"differentiated loop; read the rows in the outer body and "
                f"pass them in the inner carry")
    if save_policy not in GRAPH_POLICIES:
        raise ValueError(f"{what}: unknown save_policy {save_policy!r}")
    key = (tape.path, tape.loops, lifted.key, cond_fn is not None, spec,
           tuple(_sig(x) for x in leaves),
           tuple(_sig(c) for c in lifted.consts), int(max_iters),
           save_policy)
    tape.loops += 1
    plan = tape.owner._inner.get(key)
    if plan is None:
        if drive_mode() == "capture":
            raise RuntimeError(f"{what}: first met under capture; the "
                               f"enclosing loop's warm-up must run it")
        plan = GradLoop(lifted, cond_fn is not None, leaves, spec,
                        max_iters=max_iters, policy=save_policy, grad=True,
                        plain=bool(_PLAIN[0]), name=name, nested=True)
        tape.owner._inner[key] = plan
    return plan.nested_run(tape, leaves, lifted.consts)


class GradLoop:
    """One loop program, captured once (see the module docstring)."""

    captures = 0
    replays = 0
    host_reads = 0

    def __init__(self, lifted: _Lifted, has_cond: bool, init_leaves, spec,
                 *, max_iters: int, policy: Optional[str], grad: bool,
                 plain: bool, name: str, nested: bool = False,
                 prologue: Optional[Callable] = None):
        self.what = f"while_loop({name!r}, impl='graph')"
        self.spec, self.grad, self.policy = spec, grad, policy
        self.max_iters = int(max_iters)
        self.generation = 0
        self.nested = nested
        self._owner = None
        self._inner: Dict[tuple, GradLoop] = {}   # loops nested in the body
        self._take_template = True
        self.fwd = self.bwd = None
        self.res: Optional[ResidualStacks] = None
        self.template: Optional[_Template] = None
        self._ops: Optional[tuple] = None    # the recordings' structure
        consts = lifted.consts
        self.carry = [_static(x, False) for x in init_leaves]
        self.consts = [_static(c, grad) for c in consts]
        self.carry_arrays = [_is_dta(x) for x in init_leaves]
        self.const_arrays = [_is_dta(c) for c in consts]
        self._carry_ix = [i for i, x in enumerate(init_leaves)
                          if not _is_dta(x)]
        self._ta_ix = [i for i, x in enumerate(init_leaves) if _is_dta(x)]
        dev = next(t for x in init_leaves for t in _parts(x)).device
        self.device = dev
        self.it = torch.zeros((), dtype=torch.long, device=dev)
        body = lifted.make(0, self.consts)
        cond = lifted.make(1, self.consts) if has_cond else None
        tree = pytree.tree_unflatten(self.carry, spec)

        def fwd_body(state):
            it, carry = state
            if self.res is not None:
                return (it + 1, self._record(it))
            if grad:
                leaves = _flatten(carry)[0]
                for st, i in zip(self.stacks, self._carry_ix):
                    st.push(it, leaves[i])
            return (it + 1, body(carry))

        fwd_cond = None if cond is None else (lambda s: cond(s[1]))
        # float carry leaves, differentiated
        self._diff_ix = [i for i in self._carry_ix
                         if self.carry[i].is_floating_point()]
        self.stacks: List[CarryStack] = []
        if grad and policy in ("all", "offload"):
            self.res = ResidualStacks(
                self.max_iters, policy == "offload",
                [c for c in self.consts if torch.is_tensor(c)])
        elif grad:
            self.stacks = [CarryStack(self.carry[i], self.max_iters,
                                      policy == "carry_offload")
                           for i in self._carry_ix]
        if grad:
            self._setup_grad(lifted, consts)
        for s, x in zip(self.carry, init_leaves):
            _load(s, x)
        for s, c in zip(self.consts, consts):
            _load(s, c)
        if nested:
            loop_cls = _NestedLoop
            kw = {"before": self._before_forward}
        else:
            loop_cls = _PlainLoop if plain else device_loop.DeviceLoop
            # one stream: the gradient loop's capture differentiates the
            # graph that the forward's capture recorded
            kw = {} if plain else {"stream": torch.cuda.Stream(dev)}
        try:
            with torch.no_grad(), deferred_checks(), frame(
                    "warm", on_card=not plain):
                # eager warm-up (lazy initialisation before capture, the
                # residual stacks' shapes, and the gradient body's
                # uncovered-tensor check); a cond in the body runs both
                # branches
                self.it.zero_()
                fwd_body((self.it, tree))
                if grad:
                    self.it.fill_(1)             # pops the row just pushed
                    self.j.zero_()
                    self._grad_body((self.j, self.g_carry), check=True)
                if not plain:
                    # the capture records the template; alive, this one
                    # would lend it the constants' AccumulateGrad nodes,
                    # made on the eager stream
                    self._drop_templates()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            with torch.no_grad(), deferred_checks():
                self.fwd = loop_cls(fwd_cond, fwd_body, (self.it, tree),
                                    max_iters=self.max_iters,
                                    prologue=_enter(prologue), name=name,
                                    **kw)
                if grad:
                    self.bwd = loop_cls(
                        lambda s: s[0] < self.it, self._grad_body,
                        (self.j, self.g_carry), max_iters=self.max_iters,
                        prologue=_zero_counter, name=name + ".grad",
                        **({} if nested else kw))
        except BaseException:
            self.close()
            raise
        if not (plain or nested):
            GradLoop.captures += 1

    def _setup_grad(self, lifted: _Lifted, consts) -> None:
        dev = self.device
        make = self.res is not None      # the forward body records
        self.j = torch.zeros((), dtype=torch.long, device=dev)
        self.g_carry = [torch.zeros_like(self.carry[i])
                        for i in self._diff_ix]
        # dual arrays: the carry's float arrays and the captured arrays
        # whose source requires grad
        self._views: List[DeviceTensorArray] = []
        self.carry_duals = {}
        for i in self._ta_ix:
            ta = self.carry[i]
            g = (torch.zeros_like(ta.data) if ta.data.is_floating_point()
                 else None)
            self.carry_duals[i] = ta.dual_view(g, carry=True, make=make)
            self._views.append(self.carry_duals[i])
        values, self._acc_ix = [], []
        self.accs: List[Optional[torch.Tensor]] = []
        for k, (s, c) in enumerate(zip(self.consts, consts)):
            if _is_dta(s):
                g = (torch.zeros_like(s.data) if c.data.requires_grad
                     else None)
                view = s.dual_view(g, carry=False, make=make)
                self._views.append(view)
                values.append(view)
                self.accs.append(g)
            else:
                values.append(s)
                rg = s.requires_grad
                self.accs.append(torch.zeros_like(s) if rg else None)
                if rg:
                    self._acc_ix.append(k)
        self._body_g = lifted.make(0, values)
        self._const_leaves = [self.consts[k] for k in self._acc_ix]

    def _drop_templates(self) -> None:
        """Forget the recorded templates (this loop's and its nested
        loops'), so that the next recording, under capture, is taken."""
        self.template, self._take_template = None, True
        for plan in self._inner.values():
            plan._drop_templates()

    def _before_forward(self) -> None:
        """A nested loop's forward: under capture (and in the warm-up
        before it) it records its template anew; the plain driver keeps
        the one its warm-up recorded, which holds both branches of every
        cond."""
        if drive_mode() != "host":
            self.template, self._take_template = None, True

    def _dual_leaves(self, leaves) -> None:
        for i, view in self.carry_duals.items():
            leaves[i] = view
        for v in self._views:
            v._dual.reads.clear()
            v._dual.writes.clear()

    def _record(self, it):
        """One forward iteration under ``all``/``offload``: the body runs
        under grad and the residual hooks, which push what it saves at
        row ``it``. The graph recorded while the loop is built (the
        warm-up; on the card, the capture) is the template that the
        gradient loop differentiates."""
        leaves, xs = list(self.carry), []
        for i in self._diff_ix:
            leaves[i] = self.carry[i].detach().requires_grad_()
            xs.append(leaves[i])
        self._dual_leaves(leaves)
        take = self._take_template
        seq0 = _sequence_now() if take else 0
        tape = _Tape(self, self.res, (), self._views)
        with torch.enable_grad(), self.res.recording(it), _taping(tape):
            out = _flatten(self._body_g(pytree.tree_unflatten(
                leaves, self.spec)))[0]
            index = (lambda ix: self.res.save(ix, value=True)
                     if torch.is_tensor(ix) else int(ix))
            reads = [(v._dual.grad, index(t), leaf) for v in self._views
                     for t, leaf in v._dual.reads]
            writes = [(v._dual.grad, index(t), y) for v in self._views
                      for t, y in v._dual.writes]
        ops = tuple(n.name() for n in _nodes(
            [o for o in out if torch.is_tensor(o)] +
            [y for _, _, y in writes if torch.is_tensor(y)]))
        if self._ops is None:
            self._ops = ops
        elif ops != self._ops:
            k = next((k for k, (a, b) in enumerate(zip(ops, self._ops))
                      if a != b), min(len(ops), len(self._ops)))
            raise RuntimeError(
                f"{self.what}: an iteration of the body recorded other ops "
                f"than the first (backward node {k}: "
                f"{ops[k] if k < len(ops) else 'none'}, where the first "
                f"recorded {self._ops[k] if k < len(self._ops) else 'none'}"
                f"); save_policy {self.policy!r} replays the first "
                f"recording's graph, so every iteration must record the "
                f"same ops ('carry' re-runs the body instead)")
        if take:
            self.template = _Template(xs, out, reads, writes, seq0, tape)
            self._take_template = False
        return pytree.tree_unflatten(out, self.spec)

    def _rerun(self, k):
        """``carry``/``carry_offload``: pop carry ``k`` and re-run the
        body under grad, its arrays dual views."""
        popped = [st.pop(k) for st in self.stacks]
        leaves, xs = list(self.carry), []
        for i, p in zip(self._carry_ix, popped):
            if self.carry[i].is_floating_point():
                p = p.detach().requires_grad_()
                xs.append(p)
            leaves[i] = p
        self._dual_leaves(leaves)
        tape = _Tape(self, None, (), self._views)
        with torch.enable_grad(), _taping(tape):
            out = _flatten(self._body_g(pytree.tree_unflatten(
                leaves, self.spec)))[0]
        reads = [(v._dual.grad, t, leaf) for v in self._views
                 for t, leaf in v._dual.reads]
        writes = [(v._dual.grad, t, y) for v in self._views
                  for t, y in v._dual.writes]
        return xs, out, reads, writes, tape

    def _index(self, h):
        """A template's array index at this gradient iteration."""
        return self.res.load(h) if isinstance(h, tuple) else h

    def _grad_body(self, state, check: bool = False):
        """One gradient-loop iteration (carry ``(j, g_carry)``)."""
        j, gs = state
        k = self.it - 1 - j
        if self.res is None:
            seq0 = _sequence_now() if check else 0
            xs, out, reads, writes, tape = self._rerun(k)
        else:
            # the template's backward, through the popped residuals
            self.res.pop_group(k)
            t = self.template
            seq0, xs, out, tape = t.seq0, t.xs, t.out, t.tape
            reads = [(g, self._index(h), leaf) for g, h, leaf in t.reads]
            writes = [(g, self._index(h), y) for g, h, y in t.writes]
        outputs, gouts = [], []
        for i, g in zip(self._diff_ix, gs):
            o = out[i]
            if torch.is_tensor(o) and o.requires_grad:
                outputs.append(o)
                gouts.append(g)
        rows = []
        for dual, t, y in writes:
            if dual is not None:
                r = _row(t, dual.device)
                rows.append((dual, r))
                if torch.is_tensor(y) and y.requires_grad:
                    outputs.append(y)
                    gouts.append(dual.index_select(0, r)[0])
        inputs = xs + self._const_leaves + [leaf for _, _, leaf in reads]
        grads = _backprop(tape, outputs, gouts, inputs,
                          _Ctx(self.res, k, check, self.what), seq0)
        if self.res is not None:
            self.res.release()
        n_x, n_c = len(xs), len(self._const_leaves)
        new_gs = []
        for x, g in zip(xs, grads[:n_x]):
            if g is None:
                g = torch.zeros_like(x)
            elif any(g is s for s in gs):
                g = g.clone()
            new_gs.append(g)
        for k, g in zip(self._acc_ix, grads[n_x:n_x + n_c]):
            if g is not None:
                self.accs[k].add_(g)
        for dual, r in rows:
            dual.index_fill_(0, r, 0)
        for (dual, t, _), g in zip(reads, grads[n_x + n_c:]):
            if g is not None:
                dual.index_add_(0, _row(t, dual.device), g.unsqueeze(0))
        return (j + 1, new_gs)

    # ---------------- use -----------------------------------------------

    def busy(self) -> bool:
        return self._owner is not None and self._owner() is not None

    def forward(self, init_leaves, const_values, owner=None):
        """Load the inputs, run the forward loop (one launch), check the
        double writes; returns the carry's leaves as fresh tensors."""
        with torch.no_grad():
            for s, x in zip(self.carry, init_leaves):
                _load(s, x)
            for s, c in zip(self.consts, const_values):
                _load(s, c)
            with deferred_checks():
                self.fwd.run()
        if not isinstance(self.fwd, _PlainLoop):
            GradLoop.replays += 1
        self.generation += 1
        self._owner = None if owner is None else weakref.ref(owner)
        tas = [self.carry[i] for i in self._ta_ix]
        if self.nested:
            # the rows the inner forward wrote twice: added to the
            # enclosing loop's counter under capture
            device_loop.count_writes(
                [(t.double_writes, x.double_writes)
                 for t, x in zip(tas, [init_leaves[i]
                                       for i in self._ta_ix])], self.what)
        elif tas or getattr(self.fwd, "counts_writes", False):
            counters = [t.double_writes for t in tas]
            if getattr(self.fwd, "counts_writes", False):
                counters.append(self.fwd.double_writes)  # nested loops'
            if isinstance(self.fwd, _PlainLoop):
                dups = [int(t) for t in counters]
            else:
                dups = [int(v) for v in device_loop.read_host(*counters)]
                GradLoop.host_reads += 1
            if any(dups):
                raise WriteOnceError(
                    f"{self.what}: {sum(dups)} TensorArray write(s) to a "
                    f"written location; the gradient construction of §5.2 "
                    f"requires write-once")
        with torch.no_grad():
            return [x.clone() if not _is_dta(x) else
                    DeviceTensorArray(*[t.clone() for t in x.tensors()])
                    for x in self.carry]

    def backward(self, g_leaves, generation: int):
        """Run the gradient loop (one launch) from the carry's output
        cotangents; returns (carry cotangents, constant gradients), fresh
        tensors or None."""
        if generation != self.generation and not self.nested:
            raise RuntimeError(f"{self.what}: the loop's stacks were reused "
                               f"by a later call before this backward")
        with torch.no_grad():
            for g, i in zip(self.g_carry, self._diff_ix):
                g.copy_(g_leaves[i])
            for i, view in self.carry_duals.items():
                if view._dual.grad is not None:
                    view._dual.grad.copy_(g_leaves[i])
            for a in self.accs:
                if a is not None:
                    a.zero_()
            for v in self._views:
                if not v._dual.carry and v._dual.grad is not None:
                    v._dual.grad.zero_()
            self.bwd.run()
        if not isinstance(self.bwd, _PlainLoop):
            GradLoop.replays += 1
        self._owner = None
        with torch.no_grad():
            g_carry = [None] * len(self.carry)
            for g, i in zip(self.g_carry, self._diff_ix):
                g_carry[i] = g.clone()
            for i, view in self.carry_duals.items():
                if view._dual.grad is not None:
                    g_carry[i] = view._dual.grad.clone()
            return g_carry, [None if a is None else a.clone()
                             for a in self.accs]

    def nested_run(self, tape: _Tape, init_leaves, const_values):
        """The forward of a loop nested in a differentiated body (a
        WHILE node of it under capture), recorded on ``tape`` as an
        event whose gradient is this loop's gradient loop; returns the
        final carry, its float leaves new leaves."""
        outs = self.forward(init_leaves, const_values)
        inputs, slots = [], []
        for i, x in enumerate(init_leaves):
            t = x.data if _is_dta(x) else x
            if (i in self._diff_ix or i in self.carry_duals) and \
                    t.requires_grad:
                inputs.append(t)
                slots.append(("carry", i))
        for k, c in enumerate(const_values):
            t = c.data if _is_dta(c) else c
            if self.accs[k] is not None and t.requires_grad:
                inputs.append(t)
                slots.append(("const", k))
        outputs, out_slots = [], []
        for i, x in enumerate(outs):
            t = x.data if _is_dta(x) else x
            if i in self._diff_ix or (
                    i in self.carry_duals and
                    self.carry_duals[i]._dual.grad is not None):
                t.requires_grad_()
                outputs.append(t)
                out_slots.append(i)
        tape.events.append(_LoopEvent(self, inputs, slots, outputs,
                                      out_slots))
        return pytree.tree_unflatten(outs, self.spec)

    @property
    def host_bytes(self) -> int:
        """Pinned host bytes of the stacks (``carry_offload``: max_iters
        x ``carry_bytes``; ``offload``: max_iters x
        ``residual_bytes``)."""
        return sum(st.host_bytes for st in self.stacks) + (
            0 if self.res is None else self.res.host_bytes)

    @property
    def carry_bytes(self) -> int:
        """Bytes of the carry one iteration pushes (``carry``,
        ``carry_offload``)."""
        return sum(st.nbytes for st in self.stacks)

    @property
    def residual_bytes(self) -> int:
        """Bytes of the body's residuals one iteration pushes (``all``,
        ``offload``): each distinct saved tensor and array index once,
        the constants' views not at all."""
        return 0 if self.res is None else self.res.nbytes

    def iterations(self) -> int:
        """The last forward's trip count (one host read)."""
        return self.fwd.iterations()

    def close(self) -> None:
        for loop in (getattr(self, "fwd", None), getattr(self, "bwd", None)):
            if loop is not None:
                loop.close()
        for plan in getattr(self, "_inner", {}).values():
            plan.close()
        self._inner = {}
        self.fwd = self.bwd = None
        self.stacks = []
        self.template = self.res = None


def _zero_counter(state) -> None:
    state[0].zero_()


def _enter(prologue: Optional[Callable]) -> Callable:
    """The forward loop's prologue: the counter reset, then the caller's
    (on the carry) if given."""
    if prologue is None:
        return _zero_counter

    def enter(state):
        state[0].zero_()
        prologue(state[1])
    return enter


class _Loop(torch.autograd.Function):
    """forward: the forward graph; backward: the gradient graph."""

    @staticmethod
    def forward(ctx, plan: GradLoop, *tensors):
        n = sum(3 if ta else 1 for ta in plan.carry_arrays)
        leaves = _regroup(tensors[:n], plan.carry_arrays)
        consts = _regroup(tensors[n:], plan.const_arrays)
        token = _Token()
        outs = plan.forward(leaves, consts, owner=token)
        ctx.plan, ctx.token, ctx.generation = plan, token, plan.generation
        flat = [t for x in outs for t in _parts(x)]
        ctx.mark_non_differentiable(*[t for t in flat
                                      if not t.is_floating_point()])
        return tuple(flat)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        # an array's cotangent is its data's
        g_leaves = [x.data if _is_dta(x) else x
                    for x in _regroup(grads, plan.carry_arrays)]
        g_carry, g_consts = plan.backward(g_leaves, ctx.generation)
        out: List[Optional[torch.Tensor]] = []
        for ta, g in zip(plan.carry_arrays + plan.const_arrays,
                         g_carry + g_consts):
            out += [g, None, None] if ta else [g]
        return (None, *out)


# ---------------------------------------------------------- entry point

_CACHE: Dict[tuple, List[GradLoop]] = {}


def takes(init, body_fn, cond_fn) -> Optional[_Lifted]:
    """Does ``while_loop(impl="graph")`` go through this module: a carry
    that holds a ``DeviceTensorArray``, grad mode with a tensor that
    requires grad in the carry or among the constants, or any loop under
    ``plain_driver()``? Returns the lifted functions (for ``run``) if it
    does, else None."""
    leaves = _flatten(init)[0]
    arrays = any(_is_dta(x) for x in leaves)
    every = arrays or bool(_PLAIN[0])      # the plain driver takes all
    if not (every or torch.is_grad_enabled()):
        return None
    lifted = _Lifted([body_fn] + ([cond_fn] if cond_fn is not None
                                  else []))
    if every or any(t.requires_grad for x in leaves + lifted.consts
                    if torch.is_tensor(x) or _is_dta(x)
                    for t in _parts(x)):
        return lifted
    return None


def run(lifted: _Lifted, has_cond: bool, init, *,
        max_iters: Optional[int], save_policy: str,
        name: str = "while",
        prologue: Optional[Callable] = None) -> Tuple[Any, GradLoop]:
    """``while_loop(impl="graph")`` through a ``GradLoop`` (``lifted``
    from ``takes``): returns the final carry (fresh tensors) and the
    loop. A ``prologue`` runs on the carry before the first predicate,
    without grad only (its in-place writes would not be
    differentiated)."""
    what = f"while_loop({name!r}, impl='graph')"
    if max_iters is None:
        raise ValueError(f"{what}: the graph lowering of a loop over a "
                         f"TensorArray or under grad needs max_iters (it "
                         f"bounds the stacks, paper §5.1)")
    leaves, spec = _flatten(init)
    for x in leaves:
        if isinstance(x, (bool, int, float, complex)):
            raise TypeError(f"{what}: the carry holds a Python number "
                            f"({x!r}); a counter must be a 0-d device "
                            f"tensor")
        if not (torch.is_tensor(x) or _is_dta(x)):
            raise TypeError(f"{what}: a carry leaf of type "
                            f"{type(x).__name__}; the gradient-capable "
                            f"graph loop takes tensors and "
                            f"DeviceTensorArrays")
    plain = bool(_PLAIN[0])
    tensors = [t for x in leaves + lifted.consts for t in _parts(x)]
    if not plain and any(t.device.type != "cuda" for t in tensors):
        bad = next(t for t in tensors if t.device.type != "cuda")
        raise ValueError(f"{what}: the graph lowering runs on CUDA "
                         f"tensors; got a {bad.device} tensor (the "
                         f"host-read lowering, impl='host', runs on the "
                         f"CPU)")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    if save_policy not in GRAPH_POLICIES:
        raise ValueError(f"{what}: unknown save_policy {save_policy!r}")
    if grad and prologue is not None:
        raise NotImplementedError(f"{what}: a prologue under grad; its "
                                  f"in-place writes to the carry would not "
                                  f"be differentiated")
    key = (lifted.key, has_cond, spec,
           tuple(_sig(x) for x in leaves),
           tuple(_sig(c) for c in lifted.consts), int(max_iters),
           save_policy if grad else None, grad, plain, prologue)
    plans = _CACHE.setdefault(key, [])
    plan = next((p for p in plans if not p.busy()), None)
    if plan is None:
        plan = GradLoop(lifted, has_cond, leaves, spec,
                        max_iters=max_iters,
                        policy=save_policy if grad else None, grad=grad,
                        plain=plain, name=name, prologue=prologue)
        plans.append(plan)
    if grad:
        outs = _regroup(_Loop.apply(plan, *tensors), plan.carry_arrays)
    else:
        outs = plan.forward(leaves, lifted.consts)
    return pytree.tree_unflatten(outs, spec), plan


def release() -> None:
    """Close every cached loop (frees their graphs, stacks and static
    buffers)."""
    for plans in _CACHE.values():
        for p in plans:
            p.close()
    _CACHE.clear()
