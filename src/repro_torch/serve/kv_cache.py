"""KV cache as an API: interchangeable dense / paged implementations.

Port of ``repro/serve/kv_cache.py``. Two implementations:

- ``DenseKVCache``: per-row columns ``(L, n_rows, max_len, KV, hd)``;
- ``PagedKVCache``: fixed-size blocks in a shared pool
  ``(L, n_blocks, block, KV, hd)``, a per-row block table
  ``(n_rows, blocks_per_row)`` (``-1`` = unallocated), the free-list as
  ``refcount == 0`` and the allocating row in ``owner``. ``alloc`` and
  ``free`` are tensor ops on the device: admission and retirement need
  no host round trip.

Differences from the JAX package, all forced by PyTorch:

- The caches are updated in place (the JAX package returns new
  pytrees). ``view(layer)`` binds one layer's slice of the cache into a
  view whose ``write_prompt`` / ``write_chunk`` / ``append`` write into
  the cache itself.
- Out-of-range writes. The JAX package scatters invalid lanes to index
  ``n_blocks`` (or ``n_rows``) with ``mode="drop"``. A PyTorch scatter
  out of range errors on the CPU and trips a device assert on CUDA, and
  filtering the lanes with a mask would give data-dependent shapes and
  a host sync per write. So each cache holds one extra TRASH entry
  that such writes land in and that no read ever returns: pool block
  ``n_blocks`` (no table entry names it), dense row ``n_rows``.
- Prefix sharing is not ported yet: ``alloc`` maps no shared blocks, so
  a block's refcount never exceeds 1 and ``ensure_private`` (the JAX
  package's copy-on-write) has nothing to copy.

Reads clip unallocated ``-1`` table entries to block 0; the lanes they
expose are masked by the caller's lengths, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import resolve_device
from ..kernels import count_launch

__all__ = ["DenseKVCache", "PagedKVCache", "DenseView", "PagedView",
           "blocks_needed", "make_kv_cache"]


def blocks_needed(n_tokens, block: int):
    """Blocks covering ``n_tokens`` cache positions (int or tensor)."""
    return -(-n_tokens // block)


def _rows(rows, n: int, device) -> torch.Tensor:
    if rows is None:
        return torch.arange(n, dtype=torch.long, device=device)
    return rows.long()


def _positions(offsets, width: int) -> torch.Tensor:
    """(n, width) absolute positions ``offsets[i] + arange(width)``."""
    return offsets.long()[:, None] + torch.arange(
        width, device=offsets.device)[None, :]


def _as_rows(cur_len, n: int, device) -> torch.Tensor:
    """``cur_len`` (int or (n,) tensor) as an (n,) long tensor."""
    if torch.is_tensor(cur_len):
        return cur_len.long().expand(n)
    return torch.full((n,), int(cur_len), dtype=torch.long, device=device)


# =========================== per-layer views ================================

class DenseView:
    """One layer of a dense cache. ``k``/``v``: ``(n_rows + 1, T, KV,
    hd)``, the last row being the trash row.

    ``rows``/``mask`` (optional) bind which cache rows a batch writes
    into: batch row ``i`` is cache row ``rows[i]`` (identity when None)
    and only masked rows write."""

    def __init__(self, k, v, rows=None, mask=None):
        self.k, self.v, self.rows, self.mask = k, v, rows, mask

    @property
    def n_rows(self) -> int:
        return self.k.shape[0] - 1

    def _scatter(self, rows, pos, keep, k, v):
        """Write ``k``/``v`` (``rows.shape + (KV, hd)``) at (rows, pos);
        lanes with ``keep`` False, or a position outside the row, go to
        the trash row."""
        T = self.k.shape[1]
        keep = keep & (pos >= 0) & (pos < T)
        rix = torch.where(keep, rows, self.n_rows)
        pix = pos.clamp(0, T - 1)
        self.k[rix, pix] = k.to(self.k.dtype)
        self.v[rix, pix] = v.to(self.v.dtype)

    def write_prompt(self, k, v) -> None:
        """Write prompt K/V ``(n, S, KV, hd)`` at positions ``[0, S)``."""
        n = k.shape[0]
        self.write_chunk(k, v, torch.zeros((n,), dtype=torch.long,
                                           device=k.device))

    def write_chunk(self, k, v, offsets) -> None:
        """Write a chunk ``(n, C, KV, hd)`` at positions
        ``[offsets[i], offsets[i] + C)`` of each bound row."""
        n, C = k.shape[0], k.shape[1]
        rows = _rows(self.rows, n, k.device)[:, None].expand(n, C)
        keep = torch.ones((n, C), dtype=torch.bool, device=k.device)
        if self.mask is not None:
            keep = keep & self.mask[:, None]
        self._scatter(rows, _positions(offsets, C), keep, k, v)

    def append(self, k, v, cur_len) -> None:
        """Write one token's K/V ``(n, 1, KV, hd)`` at ``cur_len - 1``."""
        n = k.shape[0]
        rows = _rows(self.rows, n, k.device)
        pos = _as_rows(cur_len, n, k.device) - 1
        keep = (torch.ones((n,), dtype=torch.bool, device=k.device)
                if self.mask is None else self.mask)
        self._scatter(rows, pos, keep, k[:, 0], v[:, 0])

    def gather(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense ``(n, T, KV, hd)`` K and V, the bound ``rows`` applied."""
        if self.rows is None:
            return self.k[:self.n_rows], self.v[:self.n_rows]
        return self.k[self.rows.long()], self.v[self.rows.long()]

    def paged_state(self):
        """Block-table kernel operands; None: this layout is dense."""
        return None


class PagedView:
    """One layer of a paged cache: pool slices ``(n_blocks + 1, block,
    KV, hd)`` (the last block being the trash block) and the table
    shared by all layers. ``max_len`` is the logical per-row width
    ``gather`` reconstructs."""

    # Calls of ``gather`` in this process: the block-table kernels exist
    # so that the serving path never makes one (chip_smoke.py checks it).
    gather_calls = 0

    def __init__(self, k_pool, v_pool, table, max_len, rows=None,
                 mask=None):
        self.k_pool, self.v_pool, self.table = k_pool, v_pool, table
        self.max_len, self.rows, self.mask = max_len, rows, mask

    @property
    def block(self) -> int:
        return self.k_pool.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.k_pool.shape[0] - 1

    def _phys(self, rows, pos):
        """Physical (block, offset) of logical positions; unallocated
        positions, and positions outside the table, map to the trash
        block."""
        bpr = self.table.shape[1]
        col = torch.div(pos, self.block, rounding_mode="floor")
        blk = self.table[rows, col.clamp(0, bpr - 1)].long()
        ok = (blk >= 0) & (col >= 0) & (col < bpr)
        return torch.where(ok, blk, self.n_blocks), pos % self.block

    def _scatter(self, blk, off, k, v):
        self.k_pool[blk, off] = k.to(self.k_pool.dtype)
        self.v_pool[blk, off] = v.to(self.v_pool.dtype)

    def write_prompt(self, k, v) -> None:
        n = k.shape[0]
        self.write_chunk(k, v, torch.zeros((n,), dtype=torch.long,
                                           device=k.device))

    def write_chunk(self, k, v, offsets) -> None:
        """Write a chunk ``(n, C, KV, hd)`` at per-row base offsets
        through the block table; lanes past a row's allocated blocks,
        and unmasked rows, land in the trash block."""
        n, C = k.shape[0], k.shape[1]
        rows = _rows(self.rows, n, k.device)
        blk, off = self._phys(rows[:, None], _positions(offsets, C))
        if self.mask is not None:
            blk = torch.where(self.mask[:, None], blk, self.n_blocks)
        self._scatter(blk, off, k, v)

    def append(self, k, v, cur_len) -> None:
        n = k.shape[0]
        rows = _rows(self.rows, n, k.device)
        blk, off = self._phys(rows, _as_rows(cur_len, n, k.device) - 1)
        if self.mask is not None:
            blk = torch.where(self.mask, blk, self.n_blocks)
        self._scatter(blk, off, k[:, 0], v[:, 0])

    def _bound_table(self):
        return self.table if self.rows is None \
            else self.table[self.rows.long()]

    def gather(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reconstruct the dense ``(n_rows, max_len, KV, hd)`` layout
        (``-1`` entries clip to block 0). The gather fallback; the
        kernel path reads the pool through ``paged_state`` instead."""
        PagedView.gather_calls += 1
        count_launch("gather")     # on the device, in a counting graph
        table = self._bound_table()
        safe = table.clamp(min=0).long()
        n, bpr = table.shape
        kg = self.k_pool[safe].reshape((n, bpr * self.block)
                                       + self.k_pool.shape[2:])
        vg = self.v_pool[safe].reshape((n, bpr * self.block)
                                       + self.v_pool.shape[2:])
        return kg[:, :self.max_len], vg[:, :self.max_len]

    def paged_state(self):
        """Block-table kernel operands ``(k_pool, v_pool, table)`` with
        the row binding applied. A bound ``mask`` gates writes only."""
        return self.k_pool, self.v_pool, self._bound_table()


# =========================== cache implementations ==========================

class DenseKVCache:
    """``k``/``v``: ``(L, n_rows + 1, max_len, KV, hd)`` (trash row
    last). ``alloc``/``free`` are no-ops: capacity is preallocated."""

    def __init__(self, k, v):
        self.k, self.v = k, v

    @classmethod
    def create(cls, n_layers, n_rows, max_len, kv_heads, head_dim, dtype,
               device) -> "DenseKVCache":
        shape = (n_layers, n_rows + 1, max_len, kv_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def n_rows(self) -> int:
        return self.k.shape[1] - 1

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def view(self, layer: int, rows=None, mask=None) -> DenseView:
        return DenseView(self.k[layer], self.v[layer], rows=rows, mask=mask)

    def alloc(self, rows, budget, mask=None) -> "DenseKVCache":
        return self

    def free(self, rows=None, mask=None) -> "DenseKVCache":
        return self

    def ensure_private(self, rows=None, *, start, width,
                       mask=None) -> "DenseKVCache":
        return self


class PagedKVCache:
    """Block-table cache: shared pool + per-row tables + free-list.

    ``refcount[b]`` counts the table entries holding physical block
    ``b`` (0 = free); ``owner[b]`` is the row that allocated it, ``-1``
    when free. ``alloc``/``free`` update ``table``, ``refcount`` and
    ``owner`` in place (views taken earlier see the update) with the
    JAX package's exact semantics, so the
    two packages hold byte-identical tables after the same calls."""

    def __init__(self, k_pool, v_pool, table, owner, refcount,
                 max_len: int):
        self.k_pool, self.v_pool = k_pool, v_pool
        self.table, self.owner, self.refcount = table, owner, refcount
        self.max_len = max_len

    @classmethod
    def create(cls, n_layers, n_rows, max_len, kv_heads, head_dim, dtype,
               device, *, block: int = 16,
               n_blocks: Optional[int] = None) -> "PagedKVCache":
        """``n_blocks`` defaults to dense-equivalent capacity
        (``n_rows * ceil(max_len / block)``)."""
        bpr = -(-max_len // block)
        nb = n_rows * bpr if n_blocks is None else int(n_blocks)
        pshape = (n_layers, nb + 1, block, kv_heads, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(torch.zeros(pshape, dtype=dtype, device=device),
                   torch.zeros(pshape, dtype=dtype, device=device),
                   torch.full((n_rows, bpr), -1, **i32),
                   torch.full((nb,), -1, **i32),
                   torch.zeros((nb,), **i32), max_len)

    @property
    def n_rows(self) -> int:
        return self.table.shape[0]

    @property
    def block(self) -> int:
        return self.k_pool.shape[2]

    @property
    def n_blocks(self) -> int:
        return self.k_pool.shape[1] - 1

    @property
    def blocks_per_row(self) -> int:
        return self.table.shape[1]

    def view(self, layer: int, rows=None, mask=None) -> PagedView:
        return PagedView(self.k_pool[layer], self.v_pool[layer], self.table,
                         self.max_len, rows=rows, mask=mask)

    def _scatter_vec(self, vec, idx, val, fill):
        """``vec`` with ``vec[idx] = val``; ``idx == n_blocks`` drops."""
        ext = torch.cat([vec, vec.new_full((1,), fill)])
        ext[idx] = val.to(vec.dtype)
        return ext[:-1]

    def alloc(self, rows, budget, mask=None) -> "PagedKVCache":
        """Assign ``ceil(budget / block)`` fresh blocks to each masked
        row, first-fit over the free blocks in index order. All or
        nothing per row: a row whose blocks don't all fit allocates
        nothing (its table stays ``-1``) and later rows still allocate
        if theirs fit. Rows must be free (``free`` first)."""
        dev = self.table.device
        rows = rows.long()
        n = rows.shape[0]
        mask = (torch.ones((n,), dtype=torch.bool, device=dev)
                if mask is None else mask)
        need = torch.where(mask, blocks_needed(budget.long(), self.block), 0)
        j = torch.arange(self.blocks_per_row, device=dev)[None, :]
        is_free = self.refcount == 0
        free_ids = torch.argsort(torch.where(is_free, 0, 1), stable=True)
        n_free = is_free.sum()
        # Sequential first-fit: row i fits iff its blocks fit after the
        # rows admitted before it; a failed row reserves nothing.
        acc = torch.zeros((), dtype=torch.long, device=dev)
        oks, starts = [], []
        for i in range(n):
            ok = acc + need[i] <= n_free
            starts.append(acc)
            acc = acc + torch.where(ok, need[i], 0)
            oks.append(ok)
        row_ok = torch.stack(oks) & mask
        is_fresh = row_ok[:, None] & (j < need[:, None])
        want = torch.stack(starts)[:, None] + j
        phys = free_ids[want.clamp(0, self.n_blocks - 1)]
        new_rows = torch.where(is_fresh, phys, -1)
        self.table[rows] = torch.where(mask[:, None], new_rows,
                                       self.table[rows].long()).int()
        ids = torch.where(new_rows >= 0, new_rows, self.n_blocks).reshape(-1)
        rc = torch.cat([self.refcount, self.refcount.new_zeros(1)])
        rc.index_add_(0, ids, (new_rows >= 0).int().reshape(-1))
        self.refcount.copy_(rc[:-1])
        self.owner.copy_(self._scatter_vec(
            self.owner,
            torch.where(is_fresh, phys, self.n_blocks).reshape(-1),
            rows[:, None].expand(is_fresh.shape).reshape(-1), -1))
        return self

    def free(self, rows=None, mask=None) -> "PagedKVCache":
        """Drop masked rows' table references; a block returns to the
        free-list when its count reaches zero. Idempotent: a row whose
        table was already cleared decrements nothing."""
        dev = self.table.device
        n = self.n_rows
        rows = _rows(rows, n, dev)
        mask = (torch.ones((rows.shape[0],), dtype=torch.bool, device=dev)
                if mask is None else mask)
        row_freed = torch.zeros((n,), dtype=torch.bool, device=dev)
        row_freed[rows] = mask
        ids = torch.where(row_freed[:, None] & (self.table >= 0),
                          self.table.long(), self.n_blocks)
        dec = torch.zeros((self.n_blocks + 1,), dtype=torch.int32,
                          device=dev)
        dec.index_add_(0, ids.reshape(-1),
                       torch.ones_like(ids, dtype=torch.int32).reshape(-1))
        self.refcount.sub_(dec[:-1]).clamp_(min=0)
        self.owner.masked_fill_(self.refcount == 0, -1)
        self.table.masked_fill_(row_freed[:, None], -1)
        return self

    def ensure_private(self, rows=None, *, start, width,
                       mask=None) -> "PagedKVCache":
        """Copy-on-write before a write into shared blocks. Nothing is
        shared until prefix caching is ported (``alloc`` maps no shared
        blocks), so no block can need a private copy."""
        return self


def make_kv_cache(cfg, n_layers: int, n_rows: int, max_len: int, *,
                  impl: str = "dense", block: int = 16,
                  n_blocks: Optional[int] = None, device="cuda"):
    """Self-attention KV cache for ``cfg``'s head geometry, in the
    compute dtype."""
    device = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.dtype("compute")
    if impl == "dense":
        return DenseKVCache.create(n_layers, n_rows, max_len, KV, hd, dt,
                                   device)
    if impl == "paged":
        return PagedKVCache.create(n_layers, n_rows, max_len, KV, hd, dt,
                                   device, block=block, n_blocks=n_blocks)
    raise ValueError(f"unknown kv cache impl {impl!r}")
