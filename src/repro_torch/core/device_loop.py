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
  which.

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
mode (the graph records no tape: the host lowering is the
differentiable one), a Python number in the carry (a counter must be a
device tensor), a predicate that is not a CUDA tensor.

Capture runs the Python of the prologue, predicate and body once; a
host read inside them (``.item()``, ``.cpu()``, ``nonzero``,
boolean-mask indexing) fails the capture. Lazy initialisation (a
library's first call, a cached constant's first copy) must happen
before it: run the body once eagerly first, as the scheduler's
``warmup`` does.

``DeviceLoop.captures``, ``.replays`` and ``.host_reads`` count
captures, graph launches and ``read_host`` transfers in this process.
"""

from __future__ import annotations

import ctypes
import inspect
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..kernels import check, entry, stream_ptr
from .tensor_array import TensorArray

__all__ = ["DeviceLoop", "graph_cond", "read_host", "release", "run"]

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


def _refuse_leaf(x, what: str) -> None:
    if isinstance(x, (bool, int, float, complex)):
        raise TypeError(f"{what}: the carry holds a Python number ({x!r}); "
                        f"the graph lowering replays fixed addresses, so "
                        f"a counter must be a 0-d device tensor")
    if isinstance(x, TensorArray):
        raise TypeError(f"{what}: a TensorArray indexes its slots on the "
                        f"host; the graph lowering needs a device-indexed "
                        f"array (ROADMAP.md)")
    if torch.is_tensor(x):
        if x.device.type != "cuda":
            raise ValueError(f"{what}: the graph lowering runs on CUDA "
                             f"tensors; got a {x.device} tensor (the "
                             f"host-read lowering, impl='host', runs on "
                             f"the CPU)")
        if x.requires_grad:
            raise RuntimeError(f"{what}: a carry tensor requires grad; the "
                               f"graph lowering records no tape (use "
                               f"impl='host' to differentiate)")


def _check_on_card(pred, what: str) -> None:
    if not torch.is_tensor(pred) or pred.device.type != "cuda":
        raise TypeError(f"{what}: the predicate must be a CUDA tensor (the "
                        f"graph lowering decides on the device); got "
                        f"{type(pred).__name__}"
                        + (f" on {pred.device}" if torch.is_tensor(pred)
                           else ""))


def _predicate(pred, what: str, any_of: bool) -> torch.Tensor:
    """``pred`` as a 0-d int32 CUDA tensor, computed on the device (a
    vector one, with ``any_of``, holds while any element does)."""
    _check_on_card(pred, what)
    if any_of and pred.dim():
        pred = pred.any()
    elif pred.numel() != 1:
        raise ValueError(f"{what}: a branch predicate must have one "
                         f"element; got shape {tuple(pred.shape)}")
    return pred.reshape(()).to(torch.int32)


class _Recorder:
    """Captures a callable into pieces: ``("graph", CUDAGraph)`` and
    ``("if", pred, negate, pieces)``. A ``graph_cond`` during the capture
    closes the open graph, records its branch as an IF node, and opens
    the next graph."""

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
        self._close()
        sub = _Recorder(self.loop)
        out = sub.run(fn)
        self.pieces.append(("if", pred, negate, sub.pieces))
        self._open()
        return out


def graph_cond(pred, true_fn: Callable, false_fn: Callable,
               operands) -> Any:
    """``cond(..., backend="graph")``: two IF nodes in the body being
    captured, one per branch, on ``pred`` and its negation. Leaves that
    both branches return as the same object (in-place branches) pass
    through; otherwise the false branch's outputs are copied into the
    true branch's, which must not be operands."""
    what = "cond(backend='graph')"
    _check_on_card(pred, what)
    if not _Recorder.active:
        raise RuntimeError(f"{what} runs inside a body that "
                           f"while_loop(impl='graph') captures; outside "
                           f"one, use backend='native'")
    rec = _Recorder.active[-1]
    p = _predicate(pred, what, any_of=False)
    rec.loop._keep.append(p)
    t_out = rec.branch(p, lambda: true_fn(*operands), negate=False)
    ops = pytree.tree_leaves(operands)

    def merged():
        f_out = false_fn(*operands)
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
            t.copy_(f)
    rec.branch(p, merged, negate=True)
    return t_out


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
    """

    captures = 0
    replays = 0
    host_reads = 0

    def __init__(self, cond_fn: Optional[Callable], body_fn: Callable,
                 carry: Any, *, max_iters: Optional[int] = None,
                 prologue: Optional[Callable] = None,
                 name: str = "while"):
        what = f"while_loop({name!r}, impl='graph')"
        if torch.is_grad_enabled():
            raise RuntimeError(f"{what} records no gradient: call it under "
                               f"torch.no_grad() (impl='host' is the "
                               f"differentiable lowering)")
        if cond_fn is None and max_iters is None:
            raise ValueError("counted loop (cond_fn=None) requires max_iters")
        self.carry = carry
        self.leaves = pytree.tree_leaves(carry, is_leaf=_is_ta)
        for x in self.leaves:
            _refuse_leaf(x, what)
        tensors = [x for x in self.leaves if torch.is_tensor(x)]
        if not tensors:
            raise ValueError(f"{what}: the carry holds no tensor")
        dev = tensors[0].device
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(dev)
        self._graphs: List[torch.cuda.CUDAGraph] = []
        self._keep: List[torch.Tensor] = []    # predicates read by set()
        self._outer = self._exec = None
        self._trip = (None if max_iters is None else
                      torch.zeros((), dtype=torch.int32, device=dev))
        torch.cuda.current_stream(dev).synchronize()

        def enter():
            if self._trip is not None:
                self._trip.zero_()
            if prologue is not None:
                prologue(carry)

        def predicate():
            p = None if cond_fn is None else _predicate(
                cond_fn(carry), what, any_of=True)
            if self._trip is not None:
                bound = (self._trip < max_iters).to(torch.int32)
                p = bound if p is None else p * bound
            self._keep.append(p)
            return p

        def body():
            out = pytree.tree_leaves(body_fn(carry), is_leaf=_is_ta)
            if len(out) != len(self.leaves):
                raise TypeError(f"{what}: body_fn changed the carry's "
                                f"structure")
            for old, new in zip(self.leaves, out):
                if new is old:
                    continue
                if not (torch.is_tensor(old) and torch.is_tensor(new)):
                    raise TypeError(f"{what}: a non-tensor carry leaf "
                                    f"({type(old).__name__}) must come back "
                                    f"as the same object")
                old.copy_(new)
            if self._trip is not None:
                self._trip.add_(1)

        try:
            first = _Recorder(self)
            first.run(enter)
            cond_rec = _Recorder(self)
            pred = cond_rec.run(predicate)
            body_rec = _Recorder(self)
            body_rec.run(body)
            self._assemble(first.pieces, cond_rec.pieces, pred,
                           body_rec.pieces)
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
            if piece[0] == "graph":
                if _nodes(piece[1]):
                    _c("graph_loop_add_child", graph, ctypes.byref(tail),
                       _P(piece[1].raw_cuda_graph()))
                continue
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

    def _assemble(self, enter, cond, pred, body) -> None:
        outer, tail = _P(), _P()
        _c("graph_loop_create", ctypes.byref(outer))
        self._outer = outer
        self._add(outer, tail, enter + cond)
        handle, wbody, btail = _H(), _P(), _P()
        _c("graph_loop_handle", outer, ctypes.byref(handle))
        _c("graph_loop_add_set", outer, ctypes.byref(tail), handle,
           _P(pred.data_ptr()), 0)
        _c("graph_loop_add_conditional", outer, ctypes.byref(tail), handle,
           _WHILE, ctypes.byref(wbody))
        self._add(wbody, btail, body + cond)
        _c("graph_loop_add_set", wbody, ctypes.byref(btail), handle,
           _P(pred.data_ptr()), 0)
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
        _c("graph_loop_launch", self._exec, stream_ptr())
        DeviceLoop.replays += 1
        return self.carry

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
    return any(_nodes(p[1]) if p[0] == "graph" else _has_work(p[3])
               for p in pieces)


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
        name="while") -> Any:
    """``while_loop(..., impl="graph")``: replay the loop captured for
    these functions and this carry, capturing it on the first call (or
    when the carry's objects changed)."""
    fns = (cond_fn, body_fn, prologue)
    key = tuple(_weak(f) for f in fns) + (max_iters,)
    loop = _CACHE.get(key)
    if loop is not None and not loop.matches(init):
        _forget(key)
        loop = None
    if loop is None:
        loop = DeviceLoop(cond_fn, body_fn, init, max_iters=max_iters,
                          prologue=prologue, name=name)
        _CACHE[key] = loop
        for f in fns:
            if f is not None:
                weakref.finalize(getattr(f, "__self__", f), _forget,
                                 key).atexit = False
    loop.run()
    return init


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
