"""Differentiable TensorArray (paper §2.1, §5.2), in PyTorch's idiom.

The JAX package threads an immutable ``(size, *elem)`` buffer through
the loop and writes it with ``dynamic_update_index_in_dim``. Eagerly in
PyTorch that would copy the whole buffer on every write (O(size) per
step), and writing it in place would break autograd's version counters.
So the port holds the slots as a Python list of per-slot tensors:

- ``write`` returns a new array whose list shares every other slot's
  tensor: no device copy, and the old array stays valid (functional
  semantics, as in JAX);
- an ``unstack``ed array keeps its source tensor, and ``read(ix)`` is a
  view of it, so autograd's scatter of the view's gradient IS the
  paper's dual ``grad_ta.write`` and several reads of one slot sum;
- ``stack()`` is one ``torch.stack`` (unwritten slots read as zeros,
  as the JAX buffer's zero fill does).

Write-once (the §5.2 requirement for the gradient construction) is
checked on the host for every write. The JAX package skips the check
under tracing; the port never traces, so it always checks.

Indices are Python ints (or 0-d tensors, read once to the host): loop
counters stay on the host, so indexing costs no device sync.

The class is registered with ``torch.utils._pytree`` (its children are
the slot tensors, or the source), so tree utilities see through it.
``core.while_loop`` treats an array in the carry as one opaque value: its
slots are tensors of earlier iterations, already alive, and are neither
saved again nor copied per iteration.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree


class WriteOnceError(RuntimeError):
    pass


def _index(ix) -> int:
    return int(ix.item()) if torch.is_tensor(ix) else int(ix)


class TensorArray:
    """Fixed-capacity array of tensors of uniform shape and dtype."""

    def __init__(self, slots: Sequence[Optional[torch.Tensor]], elem_shape,
                 dtype, device, source: Optional[torch.Tensor] = None,
                 requires_grad: Optional[bool] = None):
        self._slots = list(slots)
        self._elem_shape = None if elem_shape is None else tuple(elem_shape)
        self._dtype = dtype
        self._device = None if device is None else torch.device(device)
        self._source = source
        if requires_grad is None:
            held = [source] if source is not None else self._slots
            requires_grad = any(t is not None and t.requires_grad
                                for t in held)
        self._requires_grad = requires_grad

    # -- constructors -------------------------------------------------------
    @staticmethod
    def create(size: int, elem_shape: Optional[Sequence[int]] = None,
               dtype=torch.float32, device=None) -> "TensorArray":
        """An array of ``size`` unwritten slots. An ``elem_shape``,
        ``dtype`` or ``device`` of None is taken from the first write
        (the JAX package needs them up front; an eager loop can take them
        late)."""
        return TensorArray([None] * int(size), elem_shape, dtype, device)

    @staticmethod
    def unstack(ts: torch.Tensor) -> "TensorArray":
        """ta.unstack(ts): element i := ts[i]; all slots marked written."""
        ts = torch.as_tensor(ts)
        return TensorArray([], ts.shape[1:], ts.dtype, ts.device, source=ts)

    # -- core ops (paper §2.1) ----------------------------------------------
    def _written(self, i: int) -> bool:
        return self._source is not None or self._slots[i] is not None

    def _check(self, i: int) -> int:
        n = self.size()
        if not -n <= i < n:
            raise IndexError(f"TensorArray index {i} out of range for size "
                             f"{n}")
        return i % n

    def read(self, ix) -> torch.Tensor:
        """ta.read(ix). Differentiable; its gradient is grad_ta.write(ix, g)."""
        i = self._check(_index(ix))
        if self._source is not None:
            return self._source[i]
        slot = self._slots[i]
        if slot is None:
            return torch.zeros(self._elem_shape, dtype=self._dtype,
                               device=self._device)
        return slot

    def write(self, ix, t) -> "TensorArray":
        """ta.write(ix, t) -> new TensorArray; each slot at most once."""
        i = self._check(_index(ix))
        if self._written(i):
            raise WriteOnceError(
                f"TensorArray location {i} written twice; the gradient "
                "construction of §5.2 requires write-once")
        t = torch.as_tensor(t, device=self._device)
        shape = self._elem_shape if self._elem_shape is not None \
            else tuple(t.shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"TensorArray element shape {shape}, got "
                             f"{tuple(t.shape)}")
        dtype = self._dtype if self._dtype is not None else t.dtype
        slots = list(self._slots)
        slots[i] = t.to(dtype)
        return TensorArray(slots, shape, dtype, t.device,
                           requires_grad=self._requires_grad
                           or slots[i].requires_grad)

    def stack(self) -> torch.Tensor:
        """ta.stack(): pack elements into one tensor (dual of unstack)."""
        if self._source is not None:
            return self._source
        if self._elem_shape is None:
            raise ValueError("stack() of a TensorArray never written and "
                             "created without elem_shape")
        zeros = None
        parts = []
        for slot in self._slots:
            if slot is None:
                if zeros is None:
                    zeros = torch.zeros(self._elem_shape, dtype=self._dtype,
                                        device=self._device)
                slot = zeros
            parts.append(slot)
        if not parts:
            return torch.zeros((0, *self._elem_shape), dtype=self._dtype,
                               device=self._device)
        return torch.stack(parts)

    def gather(self, indices) -> torch.Tensor:
        data = self.stack()
        return data[torch.as_tensor(indices, dtype=torch.long,
                                    device=data.device)]

    def size(self) -> int:
        if self._source is not None:
            return self._source.shape[0]
        return len(self._slots)

    # -- misc ---------------------------------------------------------------
    @property
    def dtype(self):
        return self._dtype

    @property
    def elem_shape(self) -> Tuple[int, ...]:
        return self._elem_shape

    @property
    def requires_grad(self) -> bool:
        return self._requires_grad

    def __repr__(self) -> str:
        return (f"TensorArray(size={self.size()}, elem_shape="
                f"{self.elem_shape}, dtype={self.dtype})")


def _flatten(ta: TensorArray):
    if ta._source is not None:
        return [ta._source], (True, ta._elem_shape, ta._dtype, ta._device)
    return list(ta._slots), (False, ta._elem_shape, ta._dtype, ta._device)


def _unflatten(children, context) -> TensorArray:
    unstacked, shape, dtype, device = context
    children = list(children)
    if unstacked:
        return TensorArray([], shape, dtype, device, source=children[0])
    return TensorArray(children, shape, dtype, device)


pytree.register_pytree_node(TensorArray, _flatten, _unflatten)
