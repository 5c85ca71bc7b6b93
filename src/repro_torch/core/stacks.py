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

On the CPU, "host memory" is the tensor's own memory: the same code
copies into plain (unpinned) chunks, with no streams, so the CPU tests
run the push/pop bookkeeping and the results match the device policies
exactly.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

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
        if t.requires_grad and t.is_leaf:
            return t.detach()                     # a loop constant
        nbytes = t.numel() * t.element_size()
        if not self.offload:
            self.saved_bytes += nbytes
            return t.detach()
        seen = self._seen.get(id(t))
        if seen is not None and seen[0]() is t and seen[1] == t._version:
            return seen[2]
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
        self._seen[id(t)] = (weakref.ref(t), t._version, slot)
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
