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
- Prefix sharing (the scheduler's prefix cache) is chosen when a paged
  cache is created (``sharing=True``). Such a cache maps shared blocks
  (``alloc(shared=, pin=)``), drops index pins (``release``) and copies
  on write (``ensure_private``) as the JAX package does. The JAX
  package hides the copy behind ``lax.cond(any(needs))``; deciding that
  on the host would be a read on every write, which a captured segment
  refuses. So inside a body that ``core.device_loop`` captures (the
  scheduler's segment) the copy sits behind ``cond(backend="graph")``,
  an IF node on ``any(needs)`` nested in the segment's branch, and
  eagerly it is branchless: every candidate lane copies, and a lane
  with nothing to copy moves the TRASH block onto itself. A cache
  created without sharing maps nothing shared, refuses
  ``shared``/``pin``, and its ``ensure_private`` stays a no-op, so the
  segment captured for it holds no copy at all.

Block shipping (disaggregated serving, ``serve/disagg.py``):
``PagedKVCache.export_rows`` gathers rows' leading table columns into a
fresh ``(L, R, n_cols, block, KV, hd)`` buffer (columns behind ``-1``
zeroed) and ``import_rows`` scatters such a buffer into another pool's
allocated rows (columns behind ``-1``, and unmasked rows, land in the
TRASH block), as the JAX package's do; the dense cache refuses both.

The audio family's cross-attention cache is not a ``KVCache``: plain
``(L, n_rows, n_frames, KV, hd)`` arrays with the batch dim at axis 1
(spliced at admission, as the SSM state is), read a layer at a time
through a ``CrossView`` (a ``DenseView`` without the trash row).

Reads clip unallocated ``-1`` table entries to block 0; the lanes they
expose are masked by the caller's lengths, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import core, resolve_device
from ..core import device_loop
from ..dist import sharding as sh
from ..kernels import count_launch

__all__ = ["DenseKVCache", "PagedKVCache", "DenseView", "CrossView",
           "PagedView", "blocks_needed", "make_kv_cache"]


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


class CrossView(DenseView):
    """A dense cache layer with no trash row, read only: the audio
    family's cross-attention K/V, ``k``/``v`` ``(n_rows, n_frames, KV,
    hd)``, written whole at admission (spliced along the batch axis)
    and read through the plain path."""

    @property
    def n_rows(self) -> int:
        return self.k.shape[0]


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

    def alloc(self, rows, budget, mask=None, shared=None,
              pin=None) -> "DenseKVCache":
        if shared is not None or pin is not None:
            raise ValueError("a dense cache shares no storage: shared/pin "
                             "need a paged cache created with sharing=True")
        return self

    def free(self, rows=None, mask=None) -> "DenseKVCache":
        return self

    def ensure_private(self, rows=None, *, start, width,
                       mask=None) -> "DenseKVCache":
        return self

    def reclaimable(self) -> torch.Tensor:
        """Dense rows hold no pool blocks: zeros."""
        return torch.zeros((self.n_rows,), dtype=torch.int32,
                           device=self.k.device)

    def export_rows(self, rows, n_cols: int):
        """Block shipping is paged only (``PagedKVCache.export_rows``)."""
        raise NotImplementedError("a dense cache ships no blocks: "
                                  "disaggregation needs kv='paged'")

    def shardings(self, rules, mesh=None, row_axis: str = sh.BATCH):
        """DTensor placements of ``{"k", "v"}`` under ``rules``: (LAYERS,
        row, -, CACHE_KV, CACHE_HD), as the JAX package's. Sized by the
        cache's rows without the trash row, which each shard holds for
        itself."""
        dims = (self.k.shape[0], self.n_rows) + tuple(self.k.shape[2:])
        s = rules.sharding((sh.LAYERS, row_axis, None, sh.CACHE_KV,
                            sh.CACHE_HD), mesh, dims=dims)
        return {"k": s, "v": s}

    def import_rows(self, rows, k_data, v_data, mask=None):
        """Block shipping is paged only (``PagedKVCache.import_rows``)."""
        raise NotImplementedError("a dense cache ships no blocks: "
                                  "disaggregation needs kv='paged'")


class PagedKVCache:
    """Block-table cache: shared pool + per-row tables + free-list.

    ``refcount[b]`` counts the references holding physical block ``b``:
    table entries across rows plus prefix-index pins (0 = free);
    ``owner[b]`` is the row that allocated (and so writes) it, ``-1``
    when free; mapping a shared block never changes it. ``alloc``,
    ``free``, ``release`` and ``ensure_private`` update ``table``,
    ``refcount``, ``owner`` and the pools in place (views taken earlier,
    and a captured graph, see the update) with the JAX package's exact
    semantics, so the two packages hold byte-identical tables after the
    same calls. ``sharing`` (fixed at creation) says whether rows may
    share blocks at all."""

    def __init__(self, k_pool, v_pool, table, owner, refcount,
                 max_len: int, sharing: bool = False):
        self.k_pool, self.v_pool = k_pool, v_pool
        self.table, self.owner, self.refcount = table, owner, refcount
        self.max_len, self.sharing = max_len, bool(sharing)

    @classmethod
    def create(cls, n_layers, n_rows, max_len, kv_heads, head_dim, dtype,
               device, *, block: int = 16, n_blocks: Optional[int] = None,
               sharing: bool = False) -> "PagedKVCache":
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
                   torch.zeros((nb,), **i32), max_len, sharing)

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

    @property
    def free_count(self) -> torch.Tensor:
        """Free blocks (``refcount == 0``), a 0-d device tensor."""
        return (self.refcount == 0).sum()

    def reclaimable(self) -> torch.Tensor:
        """(n_rows,) int32: per row, the table entries backed by a block
        with ``refcount == 1``, i.e. the blocks freeing the row would
        return to the pool (shared and index-pinned blocks only lose a
        reference). The SLO layer's victim signal."""
        ref = torch.where(self.table >= 0,
                          self.refcount[self.table.clamp(min=0).long()], 0)
        return (ref == 1).sum(dim=1).int()

    def view(self, layer: int, rows=None, mask=None) -> PagedView:
        return PagedView(self.k_pool[layer], self.v_pool[layer], self.table,
                         self.max_len, rows=rows, mask=mask)

    def _set_vec(self, vec, idx, val) -> None:
        """``vec[idx] = val`` in place; ``idx == len(vec)`` drops (the
        JAX package's ``mode="drop"``)."""
        ext = torch.cat([vec, vec.new_zeros(1)])
        ext[idx] = val.to(vec.dtype)
        vec.copy_(ext[:-1])

    def _unref(self, ids) -> None:
        """Drop one reference per entry of ``ids`` (``n_blocks`` drops);
        a block whose count reaches zero returns to the free-list."""
        dec = torch.zeros((self.n_blocks + 1,), dtype=torch.int32,
                          device=self.refcount.device)
        dec.index_add_(0, ids.reshape(-1),
                       torch.ones_like(ids, dtype=torch.int32).reshape(-1))
        self.refcount.sub_(dec[:-1]).clamp_(min=0)
        self.owner.masked_fill_(self.refcount == 0, -1)

    def _free_ids(self):
        """Free block ids in index order, free first, and their count."""
        is_free = self.refcount == 0
        return (torch.argsort(torch.where(is_free, 0, 1), stable=True),
                is_free.sum())

    def alloc(self, rows, budget, mask=None, shared=None,
              pin=None) -> "PagedKVCache":
        """Assign ``ceil(budget / block)`` blocks to each masked row,
        first-fit over the free blocks in index order. Rows must be free
        (``free`` first).

        ``shared`` (n, blocks_per_row), sharing caches only: physical
        block ids, a prefix-contiguous run padded with ``-1``, mapped
        into each row's LEADING table columns with their refcounts
        bumped instead of drawing fresh blocks (a prefix-cache hit); only
        ``need - n_shared`` fresh blocks are taken. ``pin`` (same shape,
        bool) adds one extra reference to the block mapped at each
        pinned column (a prefix-index registration that outlives the
        row).

        All or nothing per row: a row whose fresh blocks don't all fit
        allocates nothing and maps nothing (its table stays ``-1``), and
        later rows still allocate if theirs fit."""
        if (shared is not None or pin is not None) and not self.sharing:
            raise ValueError("shared/pin need a paged cache created with "
                             "sharing=True (the prefix cache)")
        dev = self.table.device
        rows = rows.long()
        n, bpr = rows.shape[0], self.blocks_per_row
        mask = (torch.ones((n,), dtype=torch.bool, device=dev)
                if mask is None else mask)
        need = torch.where(mask, blocks_needed(budget.long(), self.block), 0)
        j = torch.arange(bpr, device=dev)[None, :]
        shared = (torch.full((n, bpr), -1, dtype=torch.long, device=dev)
                  if shared is None else shared.long())
        pin = (torch.zeros((n, bpr), dtype=torch.bool, device=dev)
               if pin is None else pin)
        n_sh = torch.where(mask, ((shared >= 0) & (j < need[:, None])
                                  ).sum(dim=1), 0)
        fresh_need = need - n_sh
        free_ids, n_free = self._free_ids()
        # Sequential first-fit: row i fits iff its fresh blocks fit after
        # the rows admitted before it; a failed row reserves nothing.
        acc = torch.zeros((), dtype=torch.long, device=dev)
        oks, starts = [], []
        for i in range(n):
            ok = acc + fresh_need[i] <= n_free
            starts.append(acc)
            acc = acc + torch.where(ok, fresh_need[i], 0)
            oks.append(ok)
        row_ok = torch.stack(oks) & mask
        col_fresh = j - n_sh[:, None]
        is_shared = row_ok[:, None] & (j < n_sh[:, None])
        is_fresh = row_ok[:, None] & (col_fresh >= 0) & (j < need[:, None])
        want = torch.stack(starts)[:, None] + col_fresh
        phys = free_ids[want.clamp(0, self.n_blocks - 1)]
        new_rows = torch.where(is_shared, shared,
                               torch.where(is_fresh, phys, -1))
        self.table[rows] = torch.where(mask[:, None], new_rows,
                                       self.table[rows].long()).int()
        # +1 per mapped entry (shared or fresh), +1 more per pinned one
        mapped = new_rows >= 0
        inc = torch.where(mapped, 1 + (pin & mapped).int(), 0)
        rc = torch.cat([self.refcount, self.refcount.new_zeros(1)])
        rc.index_add_(0, torch.where(mapped, new_rows, self.n_blocks
                                     ).reshape(-1), inc.reshape(-1).int())
        self.refcount.copy_(rc[:-1])
        # owner records the ALLOCATING row: fresh blocks only
        self._set_vec(self.owner,
                      torch.where(is_fresh, phys, self.n_blocks).reshape(-1),
                      rows[:, None].expand(is_fresh.shape).reshape(-1))
        return self

    def free(self, rows=None, mask=None) -> "PagedKVCache":
        """Drop masked rows' table references; a block returns to the
        free-list when its count reaches zero (blocks still mapped by
        other rows, or pinned by the prefix index, survive). Idempotent:
        a row whose table was already cleared decrements nothing."""
        dev = self.table.device
        n = self.n_rows
        rows = _rows(rows, n, dev)
        mask = (torch.ones((rows.shape[0],), dtype=torch.bool, device=dev)
                if mask is None else mask)
        row_freed = torch.zeros((n,), dtype=torch.bool, device=dev)
        row_freed[rows] = mask
        self._unref(torch.where(row_freed[:, None] & (self.table >= 0),
                                self.table.long(), self.n_blocks))
        self.table.masked_fill_(row_freed[:, None], -1)
        return self

    def release(self, block_ids) -> "PagedKVCache":
        """Drop ONE reference from each listed physical block (``-1``
        entries ignored): the prefix index evicting its pins."""
        ids = block_ids.long()
        self._unref(torch.where(ids >= 0, ids, self.n_blocks))
        return self

    def ensure_private(self, rows=None, *, start, width,
                       mask=None) -> "PagedKVCache":
        """Copy-on-write before ``rows`` write positions ``[start, start
        + width)``: each covered block with ``refcount > 1`` that the row
        does not own is copied (every layer) to a fresh block and the
        row's entry repointed; other references keep the original bits.
        The owner writes in place (the prefix index serves a block to a
        sharer only once its owner has finished writing it). When the
        pool runs dry the entry becomes ``-1``: the write lands in the
        TRASH block and the shared bits survive. ``width`` is static,
        ``start`` an int or a per-row tensor.

        Nothing here reads the device from the host (module docstring):
        in a captured segment the copy is an IF node on ``any(needs)``;
        eagerly each of the ``(width - 1) // block + 2`` candidate
        columns of each row copies one block of every layer, a lane with
        nothing to copy the TRASH block onto itself. A cache created
        without sharing returns at once. On the scheduler's path no lane
        copies: sharing stops at full blocks before the first written
        position."""
        if not self.sharing:
            return self
        dev = self.table.device
        nb, bpr, blk_len = self.n_blocks, self.blocks_per_row, self.block
        rows = _rows(rows, self.n_rows, dev)
        n = rows.shape[0]
        mask = (torch.ones((n,), dtype=torch.bool, device=dev)
                if mask is None else mask)
        start = _as_rows(start, n, dev)
        span = (int(width) - 1) // blk_len + 2
        cols = torch.div(start, blk_len, rounding_mode="floor")[:, None] \
            + torch.arange(span, device=dev)[None, :]           # (n, span)
        covered = (cols * blk_len < (start + int(width))[:, None]) \
            & (cols >= 0) & (cols < bpr)
        ccol = cols.clamp(0, bpr - 1)
        blk = self.table[rows[:, None], ccol].long()
        safe = blk.clamp(0, nb - 1)
        needs = mask[:, None] & covered & (blk >= 0) \
            & (self.refcount[safe] > 1) & (self.owner[safe] != rows[:, None])
        if device_loop.capturing():
            core.cond(needs.any(), lambda: self._copy_on_write(
                rows, ccol, safe, needs), _no_copy, backend="graph")
        else:
            self._copy_on_write(rows, ccol, safe, needs)
        return self

    # ---- block shipping between pools (disaggregated serving) ----

    def export_rows(self, rows, n_cols: int):
        """The K/V behind ``rows``' leading ``n_cols`` table columns as
        FRESH ``(L, R, n_cols, block, KV, hd)`` buffers, the wire format
        of a shipment to another pool: they alias nothing in this pool,
        so its blocks may be recycled while the buffers are in flight.
        Columns behind ``-1`` (a short prompt's tail) come back zeroed;
        the importer's table routes them nowhere."""
        rows = rows.long()
        cols = self.table[rows, :int(n_cols)].long()        # (R, n_cols)
        dead = (cols < 0)[None, :, :, None, None, None]
        safe = cols.clamp(min=0)
        return (self.k_pool[:, safe].masked_fill_(dead, 0),
                self.v_pool[:, safe].masked_fill_(dead, 0))

    def import_rows(self, rows, k_data, v_data,
                    mask=None) -> "PagedKVCache":
        """Scatter ``export_rows``-shaped buffers into ``rows``' leading
        table columns, in place; the rows hold fresh allocations
        (``alloc`` first). Columns the destination table does not back
        (``-1``), and unmasked rows, land in the TRASH block."""
        rows = rows.long()
        n, n_cols = rows.shape[0], k_data.shape[2]
        dst = self.table[rows, :n_cols].long()              # (n, n_cols)
        ok = dst >= 0
        if mask is not None:
            ok = ok & mask[:, None]
        flat = torch.where(ok, dst, self.n_blocks).reshape(-1)
        L = k_data.shape[0]
        self.k_pool[:, flat] = k_data.to(self.k_pool.dtype).reshape(
            (L, n * n_cols) + tuple(k_data.shape[3:]))
        self.v_pool[:, flat] = v_data.to(self.v_pool.dtype).reshape(
            (L, n * n_cols) + tuple(v_data.shape[3:]))
        return self

    def shardings(self, rules, mesh=None, row_axis: str = sh.BATCH):
        """DTensor placements of the cache's tensors under ``rules``, as
        the JAX package's: the block pools (LAYERS, BLOCK, -, CACHE_KV,
        CACHE_HD), ``owner`` and ``refcount`` over ``BLOCK``, the table's
        rows over ``row_axis``. Sized by the pool's blocks without the
        trash block, which each shard holds for itself."""
        L, _, block, KV, hd = self.k_pool.shape
        pool = rules.sharding((sh.LAYERS, sh.BLOCK, None, sh.CACHE_KV,
                               sh.CACHE_HD), mesh,
                              dims=(L, self.n_blocks, block, KV, hd))
        vec = rules.sharding((sh.BLOCK,), mesh, dims=(self.n_blocks,))
        return {"k_pool": pool, "v_pool": pool,
                "table": rules.sharding((row_axis, None), mesh,
                                        dims=tuple(self.table.shape)),
                "owner": vec, "refcount": vec}

    def _copy_on_write(self, rows, ccol, safe, needs) -> None:
        """Copy the blocks ``needs`` marks (lanes: rows x candidate
        columns ``ccol``, current blocks ``safe``) to fresh blocks, in
        place; lanes without a copy move the TRASH block onto itself."""
        nb = self.n_blocks
        free_ids, n_free = self._free_ids()
        flat = needs.reshape(-1)
        order = torch.cumsum(flat.long(), 0) - 1
        ok = flat & (order < n_free)
        fresh = torch.where(ok, free_ids[order.clamp(0, nb - 1)], nb)
        src = torch.where(ok, safe.reshape(-1), nb)
        self.k_pool[:, fresh] = self.k_pool[:, src]
        self.v_pool[:, fresh] = self.v_pool[:, src]
        # repoint the row's entry (the copy, or -1 when the pool is dry);
        # the old block loses this row's reference either way
        ext = torch.cat([self.table,
                         self.table.new_full((1, self.blocks_per_row), -1)])
        ext[torch.where(needs, rows[:, None], self.n_rows).reshape(-1),
            ccol.reshape(-1)] = torch.where(ok, fresh, -1).int()
        self.table.copy_(ext[:-1])
        self._unref(torch.where(flat, safe.reshape(-1), nb))
        self._set_vec(self.refcount, fresh, torch.ones_like(fresh))
        self._set_vec(self.owner, fresh,
                      rows[:, None].expand(needs.shape).reshape(-1))


def _no_copy() -> None:
    """The untaken side of the copy's IF node: nothing to copy."""


def make_kv_cache(cfg, n_layers: int, n_rows: int, max_len: int, *,
                  impl: str = "dense", block: int = 16,
                  n_blocks: Optional[int] = None, sharing: bool = False,
                  kv_heads: Optional[int] = None, device="cuda"):
    """Self-attention KV cache for ``cfg``'s head geometry, in the
    compute dtype; ``sharing`` (paged only) lets rows share blocks.
    ``kv_heads``: the K/V heads a rank holds where ``CACHE_KV`` splits
    them over the model axis (default: all of ``cfg``'s); the block ids,
    tables, ``owner`` and ``refcount`` do not depend on it."""
    device = resolve_device(device)
    KV, hd = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.dtype("compute")
    if impl == "dense":
        if sharing:
            raise ValueError("block sharing needs the paged cache")
        return DenseKVCache.create(n_layers, n_rows, max_len, KV, hd, dt,
                                   device)
    if impl == "paged":
        return PagedKVCache.create(n_layers, n_rows, max_len, KV, hd, dt,
                                   device, block=block, n_blocks=n_blocks,
                                   sharing=sharing)
    raise ValueError(f"unknown kv cache impl {impl!r}")
