"""Bounded save-stacks for backpropagation through loops (paper Fig. 9,
§5.3), as ``torch.autograd.graph.saved_tensors_hooks``.

The paper rewrites the forward loop to *push* every intermediate value
the gradient loop needs onto a per-value stack, and the gradient loop to
*pop* them in reverse. In eager PyTorch autograd's tape already is that
stack: every tensor an op saves for its backward is a push, and its
unpack in the backward is the pop. ``SaveStack`` hooks into that tape
and decides where the pushed values live:

- on the device (policies ``all`` and ``carry``): the saved tensor is
  kept as it is (a detached alias, no copy), and its bytes are counted;
- in host memory (``offload`` and ``carry_offload``, the paper's §5.3
  GPU→CPU swapping): a push is a ``non_blocking`` device→host copy on a
  side stream into pinned memory; a pop is a host→device copy on that
  stream, prefetched one iteration ahead of the backward.

Ordering on the card. The side stream waits for the compute stream
before each push, so the copy reads a finished value; the device tensor
is ``record_stream``-ed on the side stream, so the caching allocator
does not reuse its memory before the copy has landed. At each
iteration boundary the compute stream waits for the pushes of the
iteration before the last, which bounds the device memory held by
copies in flight to about two iterations. A pop waits on the event of
its iteration's host→device copies, and the fetched tensor is
``record_stream``-ed on the compute stream.

Host memory. Pushed values are packed into pinned chunks of
``CHUNK_BYTES`` (a larger value gets a chunk of its own, rounded up to a
power of two). PyTorch's caching host allocator keeps freed pinned
blocks and hands a block of the same power-of-two size back on the next
request, so the chunks of one pass are reused by the next instead of
being pinned again (``cudaHostAlloc`` of several GB would cost seconds).
The chunks are freed with the stack, when autograd drops the last
handle: after the backward, or with the graph.

Loop constants stay where they are: a tensor that is a leaf requiring
grad (a parameter the body captures) is kept by reference under every
policy, since it is alive anyway and identical in every iteration. A
value saved by several ops of one iteration is pushed once.

A DTensor (a carry sharded over a mesh, ``dist.sharding``) is pushed as
its rank's local shard, with its mesh and placements; the pop rebuilds
the DTensor from the fetched shard, so each rank's host stack holds
only its own shard.

On the CPU, "host memory" is the tensor's own memory: the same code
copies into plain (unpinned) chunks, with no streams, so the CPU tests
run the push/pop bookkeeping and the results match the device policies
exactly.

``CarryStack`` is the contiguous lowering of the JAX package's
``repro/core/stacks.py``, for the graph lowering's gradient loop
(``core.device_grad``): one preallocated ``(max_iters, *shape)`` buffer
per saved value, pushed and popped at a 0-d device index that is never
read to the host. Under ``carry`` and ``all`` the buffer is on the
device (``index_copy_``/``index_select`` of one row). Under
``carry_offload`` and ``offload`` it is pinned host memory that the
device addresses directly (checked with ``cudaPointerGetAttributes``);
a graph memcpy node cannot take an offset known only on the device, so
push and pop are the copy kernel of ``kernels/csrc/graph_loop.cu``
(``stack_copy``), one launch a value. On the CPU (the plain driver of
the CPU tests) the offloaded buffer is a plain CPU tensor, pushed and
popped as the device one.

``ResidualStacks`` holds the ``CarryStack``s of a body's residuals
under ``all`` and ``offload``: the tensors autograd saves while the
body runs, one stack per distinct saved value (see its docstring).
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import weakref
from typing import Dict, List, Optional, Sequence

import torch

CHUNK_BYTES = 64 << 20      # pinned arena granule
ALIGN = 256                 # byte alignment of every value in a chunk


class _Slot:
    """One pushed value: its bytes in a host chunk, and its device copy
    while a pop or a prefetch holds one."""

    __slots__ = ("host", "iteration", "dev")

    def __init__(self, host: torch.Tensor, iteration: int):
        self.host = host
        self.iteration = iteration
        self.dev: Optional[torch.Tensor] = None


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class SaveStack:
    """The save-stack of one ``while_loop`` call under one policy."""

    def __init__(self, offload: bool):
        self.offload = offload
        self.iteration = 0
        self.saved_bytes = 0          # bytes of the values pushed
        self.host_bytes = 0           # of which went to host memory
        self._iters: List[List[_Slot]] = []
        self._seen: Dict[int, tuple] = {}
        self._chunks: List[torch.Tensor] = []
        self._used = CHUNK_BYTES      # bytes used in the newest chunk
        self._device: Optional[torch.device] = None
        self._side = None             # side stream (CUDA only)
        self._pushed: List = []       # event per iteration: pushes done
        self._fetched: Dict[int, object] = {}   # event per fetched iter

    def hooks(self) -> torch.autograd.graph.saved_tensors_hooks:
        return torch.autograd.graph.saved_tensors_hooks(self._push,
                                                        self._pop)

    # ---------------------------------------------------------------- push
    def _push(self, t: torch.Tensor):
        if _RECORDING[0]:
            raise NotImplementedError(
                "a while_loop(impl='host') saves tensors for its gradient "
                "inside a body whose residuals the graph lowering records "
                "(save_policy 'all'/'offload'); the gradient loop would "
                "replay the recording's values. Give the outer graph "
                "loop save_policy 'carry', or run both with impl='host'")
        if t.requires_grad and t.is_leaf:
            return t.detach()                     # a loop constant
        if not self.offload:
            local = getattr(t, "_local_tensor", t)     # a DTensor's shard
            self.saved_bytes += local.numel() * local.element_size()
            return t.detach()
        seen = self._seen.get(id(t))
        if seen is not None and seen[0]() is t and seen[1] == t._version:
            return seen[2]
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor is not None and isinstance(t, dtensor.DTensor):
            local = self._offload(t.detach().to_local())
            packed = (local, t.device_mesh, t.placements, t.shape,
                      t.stride())
        else:
            packed = self._offload(t)
        self._seen[id(t)] = (weakref.ref(t), t._version, packed)
        return packed

    def _offload(self, t: torch.Tensor) -> _Slot:
        nbytes = t.numel() * t.element_size()
        self.saved_bytes += nbytes
        self.host_bytes += nbytes
        if self._device is None:
            self._device = t.device
            if t.is_cuda:
                self._side = torch.cuda.Stream(t.device)
        while len(self._iters) <= self.iteration:
            self._iters.append([])
        host = self._alloc(nbytes).view(t.dtype).view(t.shape)
        src = t.detach()
        if self._side is not None:
            self._side.wait_stream(torch.cuda.current_stream(t.device))
            with torch.cuda.stream(self._side):
                host.copy_(src, non_blocking=True)
            src.record_stream(self._side)
        else:
            host.copy_(src)
        slot = _Slot(host, self.iteration)
        self._iters[self.iteration].append(slot)
        return slot

    def _alloc(self, nbytes: int) -> torch.Tensor:
        size = -(-max(nbytes, 1) // ALIGN) * ALIGN
        pin = self._side is not None
        if size > CHUNK_BYTES:
            chunk = torch.empty(_pow2_at_least(size), dtype=torch.uint8,
                                pin_memory=pin)
            self._chunks.append(chunk)
            return chunk[:nbytes]
        if self._used + size > CHUNK_BYTES:
            self._chunks.append(torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                            pin_memory=pin))
            self._used = 0
        out = self._chunks[-1][self._used:self._used + nbytes]
        self._used += size
        return out

    def next_iteration(self) -> None:
        """Called by the loop after each body. Ends the iteration's
        pushes; on the card, lets the compute stream run at most one
        iteration ahead of the copies."""
        self._seen.clear()
        if self._side is not None and self.iteration < len(self._iters):
            ev = torch.cuda.Event()
            ev.record(self._side)
            self._pushed.append(ev)
            if len(self._pushed) >= 2:
                torch.cuda.current_stream(self._device).wait_event(
                    self._pushed[-2])
        self.iteration += 1

    # ----------------------------------------------------------------- pop
    def _pop(self, packed):
        if torch.is_tensor(packed):
            return packed
        if isinstance(packed, tuple):           # a DTensor's local shard
            from torch.distributed.tensor import DTensor
            slot, mesh, placements, shape, stride = packed
            return DTensor.from_local(self._pop(slot), mesh, placements,
                                      run_check=False, shape=shape,
                                      stride=stride)
        slot: _Slot = packed
        it = slot.iteration
        if slot.dev is None:
            self._fetch(it)
        dev = slot.dev
        if self._side is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(self._fetched[it])
            dev.record_stream(cur)
        if it > 0:
            self._fetch(it - 1)                       # prefetch
        for later in range(it + 2, min(it + 4, len(self._iters))):
            for s in self._iters[later]:              # popped already
                s.dev = None
        return dev

    def _fetch(self, it: int) -> None:
        slots = [s for s in self._iters[it] if s.dev is None]
        if not slots:
            return
        if self._side is None:
            for s in slots:
                s.dev = s.host.clone()
            return
        with torch.cuda.stream(self._side):
            for s in slots:
                s.dev = torch.empty(s.host.shape, dtype=s.host.dtype,
                                    device=self._device)
                s.dev.copy_(s.host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._fetched[it] = ev


# ------------------------------------------------ contiguous carry stacks

_P = ctypes.c_void_p


class CarryStack:
    """The stack of one carry leaf shaped like ``like``: ``capacity``
    rows, on the device, or (``offload`` on a CUDA leaf) in pinned host
    memory."""

    def __init__(self, like: torch.Tensor, capacity: int, offload: bool):
        self.shape, self.dtype = tuple(like.shape), like.dtype
        self.nbytes = like.numel() * like.element_size()
        self.capacity = int(capacity)
        self.on_host = bool(offload)
        rows = (self.capacity, *self.shape)
        self._mapped = None
        if offload and like.is_cuda:
            self.buf = torch.empty(rows, dtype=like.dtype, pin_memory=True)
            self._mapped = _device_pointer(self.buf)
            self._out = torch.empty_like(like)       # a pop's destination
        elif offload:
            self.buf = torch.empty(rows, dtype=like.dtype)
        else:
            self.buf = torch.empty(rows, dtype=like.dtype,
                                   device=like.device)

    @property
    def host_bytes(self) -> int:
        """Bytes of host memory the stack holds."""
        return self.capacity * self.nbytes if self.on_host else 0

    def push(self, k: torch.Tensor, x: torch.Tensor) -> None:
        """Row ``k`` (a 0-d int64 tensor on ``x``'s device) := ``x``."""
        if self._mapped is not None:
            _copy(x.contiguous(), self._mapped, k, self.nbytes, to_host=True)
            return
        self.buf.index_copy_(0, k.reshape(1), x.detach().unsqueeze(0))

    def pop(self, k: torch.Tensor) -> torch.Tensor:
        """Row ``k``, on the leaf's device (under offload on the card, in
        the stack's one static destination, overwritten by the next
        pop)."""
        if self._mapped is not None:
            _copy(self._out, self._mapped, k, self.nbytes, to_host=False)
            return self._out
        return self.buf.index_select(0, k.reshape(1))[0]


_RECORDING = [0]     # > 0 while a body's residuals are being recorded


def recording_residuals() -> bool:
    """Is a body running under ``ResidualStacks.recording``?"""
    return bool(_RECORDING[0])


class ResidualStacks:
    """The stacks of one loop body's residuals (the graph lowering's
    ``all`` and ``offload``; the JAX package pushes ``vjp_fn``'s leaves).

    ``recording(it)`` runs the body under ``saved_tensors_hooks``: each
    tensor autograd saves is pushed onto its stack at row ``it`` (a 0-d
    device counter) and replaced in the graph by a handle; ``load``
    turns a handle back into a tensor, the value that ``pop_group(k,
    g)`` popped from row ``k``. Saves belong to the ``group`` current
    when they are made: ``()`` for the body, a branch's path for a
    cond's branch (``core.device_grad``), whose saves are pushed inside
    its IF node, so only the taken branch writes its rows, and popped
    inside the gradient's. The first recording of a group assigns its
    stacks (its saves in order: a new value gets a stack, a value saved
    again in the same group and iteration is pushed once); every later
    recording of the group must save the same sequence. Not pushed: a
    view of one of ``constants`` (the loop's static buffers of the
    tensors the body closes over, which no iteration changes), which
    ``load`` re-views. A view of the carry's static buffers is pushed,
    since the next iteration overwrites it. ``save(t, value=True)``
    pushes a tensor that is no saved value (an array index, a cond's
    predicate) by value, a constant's view too."""

    def __init__(self, capacity: int, offload: bool,
                 constants: Sequence[torch.Tensor]):
        self.capacity, self.offload = int(capacity), bool(offload)
        self._consts = list(constants)
        self._const_at = {c.untyped_storage().data_ptr(): k
                          for k, c in enumerate(self._consts)
                          if c.numel()}
        self.stacks: List[CarryStack] = []
        self._of: Dict[tuple, List[int]] = {}      # group -> its stacks
        self._plans: Dict[tuple, List[tuple]] = {}  # group -> its saves
        self._popped: Dict[tuple, torch.Tensor] = {}
        self._it: Optional[torch.Tensor] = None
        self.group: tuple = ()
        self._seen: Dict[tuple, int] = {}
        self._held: List[torch.Tensor] = []
        self._at: Dict[tuple, int] = {}
        self._first: set = set()

    @property
    def nbytes(self) -> int:
        """Bytes one iteration pushes (every branch's stacks counted)."""
        return sum(st.nbytes for st in self.stacks)

    @property
    def host_bytes(self) -> int:
        return sum(st.host_bytes for st in self.stacks)

    @contextlib.contextmanager
    def recording(self, it: torch.Tensor):
        """Push what the body saves at row ``it``."""
        self._it, self._seen, self._held = it, {}, []
        self._at, self._first, self.group = {}, set(), ()
        _RECORDING[0] += 1
        try:
            with torch.autograd.graph.saved_tensors_hooks(self.save,
                                                          self.load):
                yield
            for g, at in self._at.items():
                if at != len(self._plans[g]):
                    raise RuntimeError(self._differs(
                        f"{at} values where the first saved "
                        f"{len(self._plans[g])}"))
        except BaseException:
            for g in self._first:
                self._plans.pop(g, None)
            raise
        finally:
            _RECORDING[0] -= 1
            self._it, self._seen, self._held = None, {}, []
            self._first, self.group = set(), ()

    @contextlib.contextmanager
    def in_group(self, group: tuple):
        """Make the saves inside belong to ``group``."""
        outer, self.group = self.group, group
        try:
            yield
        finally:
            self.group = outer

    @staticmethod
    def _differs(what: str) -> str:
        return (f"a recording of the loop body saved {what} for its "
                f"gradient; save_policy 'all'/'offload' under "
                f"impl='graph' replay the first recording's graph, so "
                f"every iteration must save the same tensors ('carry' "
                f"re-runs the body instead)")

    def save(self, t: torch.Tensor, value: bool = False) -> tuple:
        """Push ``t`` (unless pushed already this iteration in this
        group, or, without ``value``, a constant's view); returns its
        handle."""
        if self._it is None:
            raise RuntimeError("ResidualStacks.save outside recording()")
        g = self.group
        ptr = t.untyped_storage().data_ptr()
        k = self._const_at.get(ptr) if t.numel() and not value else None
        if k is not None:
            entry = handle = ("const", k, tuple(t.shape), tuple(t.stride()),
                              t.storage_offset())
        else:
            key = (g, ptr, t.storage_offset(), tuple(t.shape),
                   tuple(t.stride()), t.dtype, t.device)
            s = self._seen.get(key)
            if s is not None:
                entry, handle = ("slot", s), ("slot", g, s)
            else:
                s = self._seen[key] = sum(1 for q in self._seen
                                          if q[0] == g)
                self._held.append(t)      # no other value takes its memory
                entry, handle = ("push", s, key[3], t.dtype), ("slot", g, s)
        if g not in self._plans:
            self._plans[g], self._of[g] = [], []
            self._first.add(g)
        plan, at = self._plans[g], self._at.get(g, 0)
        if g in self._first:
            if entry[0] == "push":
                if t.device != self._it.device:
                    raise ValueError(
                        f"the loop body saves a {t.device} tensor for its "
                        f"gradient in a loop on {self._it.device}")
                self._of[g].append(len(self.stacks))
                self.stacks.append(CarryStack(t, self.capacity,
                                              self.offload))
            plan.append(entry)
        elif at >= len(plan) or plan[at] != entry:
            first = plan[at] if at < len(plan) else "nothing"
            raise RuntimeError(self._differs(
                f"{entry} as save {at} where the first saved {first}"))
        self._at[g] = at + 1
        if entry[0] == "push":
            self.stacks[self._of[g][entry[1]]].push(self._it, t.detach())
        return handle

    def load(self, handle: tuple) -> torch.Tensor:
        """The tensor of a handle: a constant's view, or the value popped
        by the last ``pop_group`` of its group."""
        if handle[0] == "const":
            _, k, size, stride, offset = handle
            return self._consts[k].detach().as_strided(size, stride, offset)
        got = self._popped.get(handle[1:])
        if got is None:
            raise RuntimeError("a residual was unpacked outside the "
                               "gradient loop's iteration")
        return got

    def pop_group(self, k: torch.Tensor, group: tuple = ()) -> None:
        """Pop row ``k`` of every stack of ``group`` (until
        ``release``)."""
        for s, i in enumerate(self._of.get(group, ())):
            self._popped[(group, s)] = self.stacks[i].pop(k)

    def release(self) -> None:
        self._popped = {}


def _device_pointer(host: torch.Tensor) -> int:
    from ..kernels import check, entry
    dev = _P()
    fn = entry("graph_loop", "stack_device_pointer",
               [_P, ctypes.POINTER(_P)])
    check(fn(_P(host.data_ptr()), ctypes.byref(dev)),
          "stack_device_pointer: pinned host memory the device cannot "
          "address")
    return dev.value


def _copy(device: torch.Tensor, mapped: int, k: torch.Tensor, nbytes: int,
          to_host: bool) -> None:
    from ..kernels import check, entry, stream_ptr
    if k.dtype != torch.long or not k.is_cuda:
        raise TypeError("CarryStack: the index must be a 0-d int64 CUDA "
                        "tensor")
    fn = entry("graph_loop", "stack_copy",
               [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, _P])
    check(fn(_P(device.data_ptr()), _P(mapped), _P(k.data_ptr()), nbytes,
             nbytes, int(to_host), stream_ptr()), "stack_copy")
