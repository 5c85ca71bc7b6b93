"""``while_loop`` and ``cond`` decided on the device: CUDA-graph WHILE
and IF nodes (the graph lowering of paper §4's in-graph control flow).

The JAX package's ``core.while_loop`` and ``lax.cond`` compile the
predicate, the body and both branches into one XLA program; the TPU
runs the loop without the host. The eager lowering of this port
(``while_loop.py``, ``cond.py``) brings every predicate to the host
instead. A ``DeviceLoop`` captures a loop ONCE and replays it as one
graph launch, with every decision taken on the device:

    [prologue] -> [cond] -> set(h) -> WHILE(h) { [body] -> [cond] -> set(h) }

- each ``[...]`` is a child-graph node holding a graph that PyTorch
  captured (``torch.cuda.graph`` with ``keep_graph=True``; all of one
  loop's graphs share one memory pool, and they run in the order they
  were captured);
- ``set(h)`` is a one-thread kernel node of ``kernels/csrc/graph_loop.cu``
  that reads the predicate, a 0-d int32 tensor at a fixed address, and
  calls ``cudaGraphSetConditional`` (the reference's "cond, then body
  while cond" order);
- a ``cond(pred, t, f, backend="graph")`` met while the body is being
  captured closes the current graph and becomes
  ``set(h') -> IF(h') {[t]}`` then ``set(!h') -> IF {[f]}``: exactly one
  branch runs, as with the native lowering, and the host never learns
  which. Under grad, in a body of ``core.device_grad``'s loops, each
  branch runs on detached operands into a tape of its own and writes
  its results into buffers with no autograd link
  (``device_grad.cond_on_tape``); the gradient is two IF nodes on the
  same predicate (§5.1);
- a ``while_loop(impl="graph")`` met while the body is being captured
  builds no executable, stream or pool of its own: ``record_loop``
  records it into the body as a ``("while", ...)`` piece, ``[prologue]
  -> [cond] -> set(h'') -> WHILE(h'') {[body] -> [cond] -> set(h'')}``,
  a conditional node inside the enclosing body (§4's nested frames).
  Its carry is a copy of its initial carry made by the enclosing body
  inside the capture, so its tensors have fixed addresses in the
  enclosing loop's pool; a counted inner loop's remainder step stays in
  the enclosing body. Under grad ``core.device_grad`` records its
  forward and gradient loops the same way.

PyTorch 2.11 exposes no WHILE node and no IF node to Python
(``begin_capture_to_if_node`` arrived later), so the nodes are built
with the runtime's graph API around the captured graphs (PERF.md §6
records the probe).

The carry. Its tensors are allocated OUTSIDE capture and are static: a
replay reads and writes the same addresses every time. At the end of
the body each output leaf is copied into its carry leaf, except where
the body returned the carry's own object (an in-place cache is never
copied). Non-tensor leaves (a ``PagedKVCache``, updated in place) must
come back as the same object. Refused, with an error: a CPU tensor, grad
mode (the graph records no tape; ``while_loop(impl="graph")`` sends a
loop with a tensor that requires grad to ``core.device_grad``, which
builds §5.1's gradient loop from two ``DeviceLoop``s), a Python number
in the carry (a counter must be a device tensor), a predicate that is
not a CUDA tensor.

Outside a capture, ``cond(backend="graph")`` and a nested loop run only
inside a loop body that ``core.device_grad`` drives eagerly (``frame``):
its warm-up before a capture runs BOTH branches of a cond (without grad
the taken one's results kept with a select), so that both initialise
lazily and both record their stacks, and ``device_grad.plain_driver()``
decides each cond on the host; a nested loop runs step by step. Outside
every loop body a graph cond raises.

Capture runs the Python of the prologue, predicate and body once; a
host read inside them (``.item()``, ``.cpu()``, ``nonzero``,
boolean-mask indexing) fails the capture. Lazy initialisation (a
library's first call, a cached constant's first copy) must happen
before it: run the body once eagerly first, as the scheduler's
``warmup`` does.

``DeviceLoop.captures``, ``.replays`` and ``.host_reads`` count
captures, graph launches and ``read_host`` transfers in this process;
``loop.double_writes`` counts, on the device, the write-once violations
of the ``DeviceTensorArray``s carried by loops nested in ``loop`` in its
last replay (``while_loop`` checks it after the launch).
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import threading
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..kernels import check, entry, stream_ptr
from .tensor_array import (DeviceTensorArray, TensorArray, WriteOnceError,
                           deferred_checks)

__all__ = ["DeviceLoop", "branches", "capturing", "drive_mode", "eager_loop",
           "graph_cond", "nested_loop", "read_host", "record_loop",
           "release", "run"]

_P = ctypes.c_void_p
_REF = ctypes.POINTER(ctypes.c_void_p)
_H = ctypes.c_uint64
_API = {  # C entry -> argtypes (csrc/graph_loop.cu)
    "graph_loop_create": [_REF],
    "graph_loop_node_count": [_P, ctypes.POINTER(ctypes.c_size_t)],
    "graph_loop_handle": [_P, ctypes.POINTER(_H)],
    "graph_loop_add_child": [_P, _REF, _P],
    "graph_loop_add_set": [_P, _REF, _H, _P, ctypes.c_int],
    "graph_loop_add_conditional": [_P, _REF, _H, ctypes.c_int, _REF],
    "graph_loop_instantiate": [_P, _REF],
    "graph_loop_upload": [_P, _P],
    "graph_loop_launch": [_P, _P],
    "graph_loop_destroy": [_P, _P],
}
_IF, _WHILE = 0, 1


def _c(symbol: str, *args) -> None:
    check(entry("graph_loop", symbol, _API[symbol])(*args), symbol)


def _refuse_leaf(x, what: str, on_card: bool = True) -> None:
    if isinstance(x, (bool, int, float, complex)):
        raise TypeError(f"{what}: the carry holds a Python number ({x!r}); "
                        f"the graph lowering replays fixed addresses, so "
                        f"a counter must be a 0-d device tensor")
    if isinstance(x, TensorArray):
        raise TypeError(f"{what}: a TensorArray indexes its slots on the "
                        f"host; the graph lowering takes the device-indexed "
                        f"core.DeviceTensorArray")
    if torch.is_tensor(x):
        if on_card and x.device.type != "cuda":
            raise ValueError(f"{what}: the graph lowering runs on CUDA "
                             f"tensors; got a {x.device} tensor (the "
                             f"host-read lowering, impl='host', runs on "
                             f"the CPU)")
        if x.requires_grad:
            raise RuntimeError(f"{what}: a carry tensor requires grad; a "
                               f"DeviceLoop records no tape (under grad "
                               f"mode, while_loop(impl='graph') runs the "
                               f"gradient loop, core.device_grad)")


def _check_on_card(pred, what: str) -> None:
    if not torch.is_tensor(pred) or pred.device.type != "cuda":
        raise TypeError(f"{what}: the predicate must be a CUDA tensor (the "
                        f"graph lowering decides on the device); got "
                        f"{type(pred).__name__}"
                        + (f" on {pred.device}" if torch.is_tensor(pred)
                           else ""))


def _predicate(pred, what: str, any_of: bool,
               on_card: bool = True) -> torch.Tensor:
    """``pred`` as a 0-d int32 tensor, computed on its device (a vector
    one, with ``any_of``, holds while any element does); a CUDA tensor
    unless the loop is driven eagerly (``on_card`` False)."""
    if on_card:
        _check_on_card(pred, what)
    elif not torch.is_tensor(pred):
        raise TypeError(f"{what}: the predicate must be a tensor; got "
                        f"{type(pred).__name__}")
    if any_of and pred.dim():
        pred = pred.any()
    elif pred.numel() != 1:
        raise ValueError(f"{what}: a branch predicate must have one "
                         f"element; got shape {tuple(pred.shape)}")
    return pred.reshape(()).to(torch.int32)


class _Frame:
    """How the loop body now running is driven: ``"capture"`` (recorded
    by a ``_Recorder``), ``"warm"`` (a ``core.device_grad`` loop's eager
    warm-up before its capture: a cond runs both branches, so that both
    initialise and both record their stacks) or ``"host"`` (the step-by-
    step driver: a cond reads its predicate); ``on_card`` whether its
    predicates must be CUDA tensors."""

    __slots__ = ("mode", "on_card")

    def __init__(self, mode: str, on_card: bool):
        self.mode, self.on_card = mode, on_card


_LOCAL = threading.local()     # .frames: this thread's, innermost last


def _frames() -> List[_Frame]:
    if not hasattr(_LOCAL, "frames"):
        _LOCAL.frames = []
    return _LOCAL.frames


@contextlib.contextmanager
def frame(mode: Optional[str], on_card: bool = True):
    """Drive the loop bodies this thread runs inside in ``mode`` (None:
    as the enclosing frame does)."""
    frames = _frames()
    if mode is None:
        outer = frames[-1] if frames else _Frame("host", False)
        mode, on_card = outer.mode, outer.on_card
    frames.append(_Frame(mode, on_card))
    try:
        yield
    finally:
        frames.pop()


def drive_mode() -> Optional[str]:
    """The innermost frame's mode on this thread: "capture", "warm",
    "host", or None outside every loop body."""
    frames = _frames()
    return frames[-1].mode if frames else None


class _Recorder:
    """Captures a callable into pieces: ``("graph", CUDAGraph)``,
    ``("if", pred, negate, pieces)`` and ``("while", enter, cond, pred,
    body, tail)``. A ``graph_cond`` or a nested loop during the capture
    closes the open graph, records its pieces, and opens the next
    graph."""

    active: List["_Recorder"] = []     # innermost last

    def __init__(self, loop: "DeviceLoop"):
        self.loop, self.pieces = loop, []
        self._ctx = self._graph = None

    def _open(self) -> None:
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._ctx = torch.cuda.graph(self._graph, pool=self.loop._pool,
                                     stream=self.loop._stream)
        self._ctx.__enter__()

    def _close(self) -> None:
        ctx, graph = self._ctx, self._graph
        self._ctx = self._graph = None
        with warnings.catch_warnings():   # an empty piece is dropped
            warnings.filterwarnings("ignore", message=".*Graph is empty")
            ctx.__exit__(None, None, None)
        self.loop._graphs.append(graph)
        self.pieces.append(("graph", graph))

    def run(self, fn: Callable[[], Any]) -> Any:
        _Recorder.active.append(self)
        try:
            with frame("capture"):
                self._open()
                out = fn()
                self._close()
        except BaseException:
            if self._ctx is not None:     # end the stream's capture
                try:
                    self._close()
                except Exception:
                    pass
            raise
        finally:
            _Recorder.active.pop()
        return out

    def branch(self, pred: torch.Tensor, fn: Callable[[], Any],
               negate: bool) -> Any:
        """Record ``fn`` as an IF node on ``pred`` (or its negation)."""
        self._close()
        sub = _Recorder(self.loop)
        out = sub.run(fn)
        self.loop._keep.append(pred)
        self.pieces.append(("if", pred, negate, sub.pieces))
        self._open()
        return out

    def nest(self, record: Callable[[], tuple]) -> None:
        """Record a nested loop: ``record()`` captures its pieces with
        recorders of this loop and returns its ``("while", ...)``
        piece."""
        self._close()
        self.pieces.append(record())
        self._open()


def capturing() -> bool:
    """Is a body that ``DeviceLoop`` captures being recorded (so that
    ``cond(backend="graph")`` may be called)?"""
    return bool(_Recorder.active)


def graph_cond(pred, true_fn: Callable, false_fn: Callable,
               operands) -> Any:
    """``cond(..., backend="graph")``: two IF nodes in the body being
    captured, one per branch, on ``pred`` and its negation. Leaves that
    both branches return as the same object (in-place branches) pass
    through; otherwise the false branch's outputs are copied into the
    true branch's, which must not be operands. Under grad in a body of
    ``core.device_grad``'s loops, ``device_grad.cond_on_tape`` keeps the
    branches' tapes apart. Driven eagerly (see the module docstring),
    the warm-up runs both branches and the plain driver one."""
    what = "cond(backend='graph')"
    mode = drive_mode()
    on_card = mode is None or _frames()[-1].on_card
    if mode is None:
        _check_on_card(pred, what)
        raise RuntimeError(f"{what} runs inside a body that "
                           f"while_loop(impl='graph') captures; outside "
                           f"one, use backend='native'")
    p = _predicate(pred, what, any_of=False, on_card=on_card)
    from . import device_grad
    if torch.is_grad_enabled() and device_grad.active_tape() is not None:
        return device_grad.cond_on_tape(p, true_fn, false_fn, operands)
    ops = pytree.tree_leaves(operands)
    if mode == "host":
        out = true_fn(*operands) if bool(p) else false_fn(*operands)
    elif mode == "warm":
        out = true_fn(*operands)
        _merge(out, false_fn(*operands), ops, p)
    else:
        rec = _Recorder.active[-1]
        out = rec.branch(p, lambda: true_fn(*operands), negate=False)
        rec.branch(p, lambda: _merge(out, false_fn(*operands), ops),
                   negate=True)
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in pytree.tree_leaves(out)):
        raise RuntimeError(
            f"{what} under grad outside the body of a differentiated "
            f"while_loop(impl='graph'): its outputs would carry an autograd "
            f"link through both branches; call it inside such a body (or "
            f"use backend='native')")
    return out


def branches(p: torch.Tensor, true_fn: Callable[[], None],
             false_fn: Callable[[], None]) -> None:
    """Run exactly one of two side-effect-only branches on the 0-d int32
    ``p``, as the enclosing frame drives: two IF nodes under capture,
    both in the warm-up, the taken one on the host."""
    mode = drive_mode()
    if mode == "capture":
        rec = _Recorder.active[-1]
        rec.branch(p, true_fn, negate=False)
        rec.branch(p, false_fn, negate=True)
    elif mode == "warm":
        true_fn()
        false_fn()
    elif mode == "host":
        (true_fn if bool(p) else false_fn)()
    else:
        raise RuntimeError("device_loop.branches runs inside a loop body")


def _merge(t_out, f_out, ops, select: Optional[torch.Tensor] = None):
    """The false branch's results into the true branch's (where
    ``select`` is 0, if given)."""
    t_leaves, t_spec = pytree.tree_flatten(t_out)
    f_leaves, f_spec = pytree.tree_flatten(f_out)
    if t_spec != f_spec:
        raise TypeError(f"cond(backend='graph'): the branches return "
                        f"different structures: {t_spec} vs {f_spec}")
    for t, f in zip(t_leaves, f_leaves):
        if t is f:
            continue
        if not torch.is_tensor(t) or any(t is o for o in ops):
            raise TypeError(
                "cond(backend='graph'): the true branch returns an "
                "operand (or a non-tensor) where the false branch "
                "returns something else; return a new tensor (e.g. "
                "x.clone()) so that the false branch's result can be "
                "copied into it")
        t.copy_(f if select is None else torch.where(select.bool(), t, f))


def _record_while(owner: "DeviceLoop", cond_fn, body_fn, carry, leaves,
                  *, max_iters, prologue, unroll, what,
                  trip: Optional[torch.Tensor]) -> tuple:
    """Capture a loop with recorders of ``owner`` into its
    ``("while", enter, cond, pred, body, tail)`` piece: ``enter`` resets
    the trip counter and runs the prologue, the WHILE node takes
    ``max_iters // unroll`` steps of ``unroll`` body copies and ``tail``
    the remainder's copies."""
    steps = None if max_iters is None else max_iters // unroll
    remainder = 0 if max_iters is None else max_iters % unroll

    def enter():
        if trip is not None:
            trip.zero_()
        if prologue is not None:
            prologue(carry)

    def predicate():
        p = None if cond_fn is None else _predicate(
            cond_fn(carry), what, any_of=True)
        if trip is not None:
            bound = (trip < steps).to(torch.int32)
            p = bound if p is None else p * bound
        owner._keep.append(p)
        return p

    def body(copies):
        for _ in range(copies):
            _step(body_fn, carry, leaves, what)
        if trip is not None:
            trip.add_(1)

    first = _Recorder(owner)
    first.run(enter)
    cond_rec = _Recorder(owner)
    pred = cond_rec.run(predicate)
    body_rec = _Recorder(owner)
    body_rec.run(lambda: body(unroll))
    tail_rec = _Recorder(owner)
    if remainder:
        tail_rec.run(lambda: body(remainder))
    return ("while", first.pieces, cond_rec.pieces, pred, body_rec.pieces,
            tail_rec.pieces)


def _step(body_fn, carry, leaves, what: str) -> None:
    """One body call, its outputs copied into the carry's leaves."""
    out = pytree.tree_leaves(body_fn(carry), is_leaf=_is_ta)
    if len(out) != len(leaves):
        raise TypeError(f"{what}: body_fn changed the carry's structure")
    for old, new in zip(leaves, out):
        if new is old:
            continue
        if not (torch.is_tensor(old) and torch.is_tensor(new)):
            raise TypeError(f"{what}: a non-tensor carry leaf "
                            f"({type(old).__name__}) must come back as the "
                            f"same object")
        old.copy_(new)


def _check_loop(cond_fn, max_iters, unroll, what: str) -> None:
    if unroll > 1 and cond_fn is not None:
        raise ValueError(f"{what}: unroll applies to a counted loop")
    if cond_fn is None and max_iters is None:
        raise ValueError("counted loop (cond_fn=None) requires max_iters")


def record_loop(cond_fn: Optional[Callable], body_fn: Callable, carry: Any,
                *, max_iters: Optional[int] = None,
                prologue: Optional[Callable] = None, name: str = "while",
                unroll: int = 1) -> Any:
    """A loop nested in the body being captured: recorded as a WHILE
    node of that body (no executable, no stream and no pool of its own;
    the enclosing loop's replay runs it). ``carry`` is its static carry,
    updated in place as by ``DeviceLoop``: tensors that stay alive until
    the enclosing capture ends (made by the enclosing body inside the
    capture, they have fixed addresses in its pool). Returns ``carry``."""
    what = f"while_loop({name!r}, impl='graph') nested in a graph loop"
    if not _Recorder.active:
        raise RuntimeError(f"{what}: record_loop runs inside a capture")
    _check_loop(cond_fn, max_iters, unroll, what)
    leaves = pytree.tree_leaves(carry, is_leaf=_is_ta)
    for x in leaves:
        _refuse_leaf(x, what)
    tensors = [x for x in leaves if torch.is_tensor(x)]
    if not tensors:
        raise ValueError(f"{what}: the carry holds no tensor")
    rec = _Recorder.active[-1]
    owner = rec.loop
    trip = None
    if max_iters is not None:
        trip = torch.empty((), dtype=torch.int32, device=tensors[0].device)
        owner._keep.append(trip)
    rec.nest(lambda: _record_while(
        owner, cond_fn, body_fn, carry, leaves, max_iters=max_iters,
        prologue=prologue, unroll=unroll, what=what, trip=trip))
    return carry


def eager_loop(cond_fn: Optional[Callable], body_fn: Callable, carry: Any,
               *, max_iters: Optional[int] = None,
               prologue: Optional[Callable] = None,
               name: str = "while") -> int:
    """The same loop run step by step, each predicate read on the host
    (the warm-up and the plain driver); ``carry`` updated in place.
    Returns the trip count."""
    what = f"while_loop({name!r}, impl='graph')"
    leaves = pytree.tree_leaves(carry, is_leaf=_is_ta)
    if prologue is not None:
        prologue(carry)
    n = 0
    while (max_iters is None or n < max_iters) and (
            cond_fn is None or bool(_predicate(cond_fn(carry), what,
                                               any_of=True, on_card=False))):
        _step(body_fn, carry, leaves, what)
        n += 1
    return n


def _fresh(x):
    """A nested loop's own copy of a carry leaf (a tensor or a device
    array; anything else is updated in place and passes through)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, DeviceTensorArray):
        return DeviceTensorArray(*[t.clone() for t in x.tensors()])
    return x


def _is_dta(x) -> bool:
    return isinstance(x, DeviceTensorArray)


def nested_loop(cond_fn: Optional[Callable], body_fn: Callable, init: Any,
                *, max_iters: Optional[int] = None,
                prologue: Optional[Callable] = None, name: str = "while",
                unroll: int = 1) -> Any:
    """``while_loop(impl="graph")`` without grad, called in a loop body
    that a graph loop drives (§4's nested frames): on a copy of ``init``,
    recorded as a WHILE node of the body being captured, or run step by
    step when the body is driven eagerly. The double writes of its
    carry's device arrays count into the enclosing loop's
    ``double_writes`` (checked after its launch). Returns the final
    carry."""
    what = f"while_loop({name!r}, impl='graph') nested in a graph loop"
    _check_loop(cond_fn, max_iters, unroll, what)
    olds = [x for x in pytree.tree_leaves(init, is_leaf=_is_dta)
            if _is_dta(x)]
    carry = pytree.tree_map(_fresh, init, is_leaf=_is_dta)
    for x in pytree.tree_leaves(carry, is_leaf=_is_ta):
        _refuse_leaf(x, what, on_card=_frames()[-1].on_card)
    news = [x for x in pytree.tree_leaves(carry, is_leaf=_is_dta)
            if _is_dta(x)]
    if drive_mode() == "capture":
        record_loop(cond_fn, body_fn, carry, max_iters=max_iters,
                    prologue=prologue, name=name, unroll=unroll)
    else:
        with deferred_checks():
            eager_loop(cond_fn, body_fn, carry, max_iters=max_iters,
                       prologue=prologue, name=name)
    count_writes([(n.double_writes, o.double_writes)
                  for n, o in zip(news, olds)], what)
    return carry


def count_writes(pairs, what: str) -> None:
    """Double writes a nested loop made to its device arrays, ``(after,
    before)`` counters: under capture added to the enclosing loop's
    ``double_writes``, else checked on the host at once."""
    if not pairs:
        return
    if drive_mode() == "capture":
        owner = _Recorder.active[-1].loop
        for new, old in pairs:
            owner.double_writes.add_(new - old)
        owner.counts_writes = True
        return
    dups = sum(int(new) - int(old) for new, old in pairs)
    if dups:
        raise WriteOnceError(f"{what}: {dups} TensorArray write(s) to a "
                             f"written location; the gradient construction "
                             f"of §5.2 requires write-once")


class DeviceLoop:
    """One loop captured once, replayed by ``run`` as one graph launch.

    Args:
      cond_fn: carry -> CUDA bool/int tensor (a vector one holds while
        any element does); ``None`` for a counted loop of ``max_iters``.
      body_fn: carry -> carry (same structure; see the module docstring
        for how outputs reach the carry).
      carry: the static carry (CUDA tensors and in-place objects).
      max_iters: bound on the iterations of one replay (a device
        counter, reset by each replay).
      prologue: carry -> None, run once per replay before the first
        predicate (the JAX scheduler's segment clears ``done`` there).
      unroll: body copies per WHILE-node iteration, for a counted loop
        (``while_loop``'s ``parallel_iterations`` window): the WHILE
        node takes ``max_iters // unroll`` iterations, and the
        remainder step after it, in the same graph, runs the other
        ``max_iters % unroll`` copies (``lax.scan(unroll=)``'s
        remainder). ``iterations()`` reads the loop steps of the last
        replay, the remainder step included: ``ceil(max_iters /
        unroll)``.
      stream: the stream the loop is captured on (a new one by
        default). Two loops whose graphs meet (a forward whose recorded
        autograd graph the other's capture differentiates) share one.

    ``double_writes`` (0-d int32) counts the write-once violations of
    the device arrays carried by loops nested in this one, in the last
    replay (``counts_writes`` says whether any such loop was recorded;
    ``check_writes`` reads it).
    """

    captures = 0
    replays = 0
    host_reads = 0

    def __init__(self, cond_fn: Optional[Callable], body_fn: Callable,
                 carry: Any, *, max_iters: Optional[int] = None,
                 prologue: Optional[Callable] = None,
                 name: str = "while", unroll: int = 1,
                 stream: Optional[torch.cuda.Stream] = None):
        what = f"while_loop({name!r}, impl='graph')"
        _check_loop(cond_fn, max_iters, unroll, what)
        if torch.is_grad_enabled():
            raise RuntimeError(f"{what} records no gradient: call it under "
                               f"torch.no_grad() (a loop with a tensor that "
                               f"requires grad takes core.device_grad)")
        self.carry = carry
        self.leaves = pytree.tree_leaves(carry, is_leaf=_is_ta)
        for x in self.leaves:
            _refuse_leaf(x, what)
        tensors = [x for x in self.leaves if torch.is_tensor(x)]
        if not tensors:
            raise ValueError(f"{what}: the carry holds no tensor")
        dev = tensors[0].device
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = stream if stream is not None else \
            torch.cuda.Stream(dev)
        self._graphs: List[torch.cuda.CUDAGraph] = []
        self._keep: List[torch.Tensor] = []    # predicates read by set()
        self._outer = self._exec = None
        self._trip = (None if max_iters is None else
                      torch.zeros((), dtype=torch.int32, device=dev))
        self.double_writes = torch.zeros((), dtype=torch.int32, device=dev)
        self.counts_writes = False
        self.remainder = 0 if max_iters is None else max_iters % unroll
        torch.cuda.current_stream(dev).synchronize()
        try:
            self._assemble(_record_while(
                self, cond_fn, body_fn, carry, self.leaves,
                max_iters=max_iters, prologue=prologue, unroll=unroll,
                what=what, trip=self._trip))
        except BaseException:
            self.close()
            raise
        DeviceLoop.captures += 1

    # ---------------- graph assembly ------------------------------------

    def _add(self, graph, tail, pieces) -> None:
        """Append ``pieces`` after ``tail`` in ``graph``; graphs that
        captured nothing, and IF nodes whose branch did nothing, are
        left out."""
        for piece in pieces:
            kind = piece[0]
            if kind == "graph":
                if _nodes(piece[1]):
                    _c("graph_loop_add_child", graph, ctypes.byref(tail),
                       _P(piece[1].raw_cuda_graph()))
            elif kind == "if":
                _, pred, negate, sub = piece
                if not _has_work(sub):
                    continue
                handle, body, btail = _H(), _P(), _P()
                _c("graph_loop_handle", graph, ctypes.byref(handle))
                _c("graph_loop_add_set", graph, ctypes.byref(tail), handle,
                   _P(pred.data_ptr()), int(negate))
                _c("graph_loop_add_conditional", graph, ctypes.byref(tail),
                   handle, _IF, ctypes.byref(body))
                self._add(body, btail, sub)
            else:
                self._add_while(graph, tail, piece)

    def _add_while(self, graph, tail, piece) -> None:
        """``[enter] -> [cond] -> set(h) -> WHILE(h) {[body] -> [cond] ->
        set(h)} -> [tail]`` after ``tail`` in ``graph``."""
        _, enter, cond, pred, body, tail_pieces = piece
        self._add(graph, tail, enter + cond)
        handle, wbody, btail = _H(), _P(), _P()
        _c("graph_loop_handle", graph, ctypes.byref(handle))
        _c("graph_loop_add_set", graph, ctypes.byref(tail), handle,
           _P(pred.data_ptr()), 0)
        _c("graph_loop_add_conditional", graph, ctypes.byref(tail), handle,
           _WHILE, ctypes.byref(wbody))
        self._add(wbody, btail, body + cond)
        _c("graph_loop_add_set", wbody, ctypes.byref(btail), handle,
           _P(pred.data_ptr()), 0)
        self._add(graph, tail, tail_pieces)

    def _assemble(self, piece) -> None:
        outer, tail = _P(), _P()
        _c("graph_loop_create", ctypes.byref(outer))
        self._outer = outer
        self._add_while(outer, tail, piece)
        exe = _P()
        _c("graph_loop_instantiate", outer, ctypes.byref(exe))
        self._exec = exe
        _c("graph_loop_upload", exe, stream_ptr())

    # ---------------- use -----------------------------------------------

    def run(self) -> Any:
        """Launch the loop on the current stream (no host sync); returns
        the carry, updated in place when the launch completes."""
        if self._exec is None:
            raise RuntimeError("DeviceLoop: closed")
        if self.counts_writes:
            self.double_writes.zero_()
        _c("graph_loop_launch", self._exec, stream_ptr())
        DeviceLoop.replays += 1
        return self.carry

    def check_writes(self, what: str) -> None:
        """Raise ``WriteOnceError`` if the last replay's nested loops
        wrote a written row of their device arrays (one host read, after
        the replay completes; none if no nested loop carries an
        array)."""
        if not self.counts_writes:
            return
        dups = int(read_host(self.double_writes)[0])
        if dups:
            raise WriteOnceError(f"{what}: {dups} TensorArray write(s) to a "
                                 f"written location in a nested loop; the "
                                 f"gradient construction of §5.2 requires "
                                 f"write-once")

    def iterations(self) -> int:
        """Loop steps of the last replay of a counted loop: the WHILE
        node's iterations, plus one for a remainder step (one host
        read, after the replay completes)."""
        return int(read_host(self._trip)[0])

    def close(self) -> None:
        """Free the graphs (and so their memory pool)."""
        if self._exec is not None or self._outer is not None:
            torch.cuda.synchronize()
            _c("graph_loop_destroy", self._outer or _P(), self._exec or _P())
        self._exec = self._outer = None
        for g in self._graphs:
            g.reset()
        self._graphs, self._keep = [], []
        self.carry, self.leaves = None, []

    def matches(self, carry) -> bool:
        """Was this loop captured for exactly these carry objects?"""
        leaves = pytree.tree_leaves(carry, is_leaf=_is_ta)
        return len(leaves) == len(self.leaves) and all(
            a is b for a, b in zip(leaves, self.leaves))


def _is_ta(x) -> bool:
    return isinstance(x, TensorArray)


def _nodes(graph: torch.cuda.CUDAGraph) -> int:
    n = ctypes.c_size_t()
    _c("graph_loop_node_count", _P(graph.raw_cuda_graph()), ctypes.byref(n))
    return n.value


def _has_work(pieces) -> bool:
    """Does any piece launch something (a nested loop always does: its
    predicate's set node)?"""
    return any(_nodes(p[1]) if p[0] == "graph" else
               _has_work(p[3]) if p[0] == "if" else True for p in pieces)


# ---------------- while_loop(impl="graph") -----------------------------
#
# A caller that replays one loop for its whole life (the serving
# scheduler) holds its ``DeviceLoop``. ``while_loop(impl="graph")`` keeps
# the loop it captured for a predicate, body and prologue, weakly: the
# entry goes, and its graphs are freed, when one of those functions (a
# bound method's object) is collected, so the cache keeps no caller
# alive and closes no loop that is still in use.

_CACHE: Dict[tuple, DeviceLoop] = {}


def _weak(fn):
    if fn is None:
        return None
    return weakref.WeakMethod(fn) if inspect.ismethod(fn) else \
        weakref.ref(fn)


def _forget(key) -> None:
    loop = _CACHE.pop(key, None)
    if loop is not None:
        loop.close()


def run(cond_fn, body_fn, init, *, max_iters=None, prologue=None,
        name="while", unroll=1) -> DeviceLoop:
    """``while_loop(..., impl="graph")``: replay the loop captured for
    these functions and this carry, capturing it on the first call (or
    when the carry's objects changed); returns the ``DeviceLoop``."""
    fns = (cond_fn, body_fn, prologue)
    key = tuple(_weak(f) for f in fns) + (max_iters, unroll)
    loop = _CACHE.get(key)
    if loop is not None and not loop.matches(init):
        _forget(key)
        loop = None
    if loop is None:
        loop = DeviceLoop(cond_fn, body_fn, init, max_iters=max_iters,
                          prologue=prologue, name=name, unroll=unroll)
        _CACHE[key] = loop
        for f in fns:
            if f is not None:
                weakref.finalize(getattr(f, "__self__", f), _forget,
                                 key).atexit = False
    loop.run()
    loop.check_writes(f"while_loop({name!r}, impl='graph')")
    return loop


def release(fn) -> None:
    """Close every cached loop captured with ``fn`` as its predicate,
    body or prologue."""
    for key in [k for k in _CACHE
                if any(r is not None and r() == fn for r in k[:3])]:
        _forget(key)


def read_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Bring several small device tensors to the host in ONE transfer
    (their bytes packed on the device); counted in
    ``DeviceLoop.host_reads``."""
    flat = [t.detach().reshape(-1).contiguous().view(torch.uint8)
            for t in tensors]
    raw = torch.cat(flat).cpu().numpy()
    DeviceLoop.host_reads += 1
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(raw[at:at + n].view(dt).reshape(tuple(t.shape)))
        at += n
    return out
