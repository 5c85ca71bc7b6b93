"""The prefix cache in the port: refcounted block sharing in
``PagedKVCache`` and the scheduler's prefix index, against the JAX
package and against the port's own cache-off runs.

- Cache level (as ``tests/serve/test_prefix_cache.py``): the refcount
  lifecycle, shared alloc, a pin outliving its row until ``release``,
  all-or-nothing at exhaustion, copy-on-write (a sharer copies, the owner
  writes in place, a dry pool drops the write), ``reclaimable``; and a
  random sequence of alloc/free/pin/share/CoW/release against the JAX
  cache, equal table, refcount, owner, pools and ``reclaimable`` after
  every op (integers exactly; the pools are copies of the same fp32
  bits).
- Property tests (hypothesis, as ``test_prefix_cache_property.py``):
  refcounts equal table occurrences plus pins; the scheduler's host
  free-block mirror equals the device's free count after every round.
- The scheduler against the JAX one (fp32, the JAX weights through
  ``bridge.from_numpy``, numpy-seeded prompts): equal streams, equal
  ``prefix_hit_blocks`` and ``prefix_evictions``, and equal block tables
  after every round, on traffic with hits and on traffic that evicts.
- Inside the port: warm streams equal cold ones and the cache-off run's
  (token for token); a warm admission skips the hit's chunks; twice the
  residents at an equal pool; chunked + prefix cache + n-gram
  speculation, paged, equals ``engine.generate_batch_sync``; one host
  read a segment beside the host-read loop's flag reads.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo
from repro.serve import kv_cache as jkvc
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import device_loop
from repro_torch.serve import engine, kv_cache as kvc
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib


def _mk(n_rows=4, max_len=12, block=4, n_blocks=None, L=2, KV=2, hd=8,
        sharing=True):
    return kvc.PagedKVCache.create(L, n_rows, max_len, KV, hd,
                                   torch.float32, "cpu", block=block,
                                   n_blocks=n_blocks, sharing=sharing)


def _t(a, dtype=torch.int32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _refcounts_from_state(c):
    """Table occurrences of every block (pins are added by callers)."""
    rc = np.zeros(c.n_blocks, np.int64)
    for b in c.table.numpy().reshape(-1):
        if b >= 0:
            rc[b] += 1
    return rc


def _write_rows(c, rows, seed=11):
    """Random K = V written at every position of ``rows`` (layer 0);
    returns the (n, max_len, KV, hd) values."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((len(rows), c.max_len) + tuple(c.k_pool.shape[3:]),
                    generator=g)
    c.view(0, rows=_t(rows)).write_prompt(k, k)
    return k


# ------------------------------------------------------------ cache level

def test_alloc_free_refcount_lifecycle():
    c = _mk(n_rows=2, max_len=8, block=4, n_blocks=4)
    c.alloc(_t([0, 1]), _t([8, 4]))
    np.testing.assert_array_equal(c.refcount.numpy(),
                                  _refcounts_from_state(c))
    assert int(c.free_count) == 1
    c.free(mask=torch.tensor([True, False]))
    rc = c.refcount.numpy()
    np.testing.assert_array_equal(rc, _refcounts_from_state(c))
    assert int(c.free_count) == 3
    assert (c.owner.numpy()[rc == 0] == -1).all()


def test_shared_alloc_maps_blocks_and_counts_references():
    """Shared columns map the donor's physical blocks (the same storage:
    the sharer reads the donor's bits), refcounts go up, owners stay the
    donor's, fresh blocks fill the rest."""
    c = _mk(n_rows=3, max_len=16, block=4, n_blocks=8)
    c.alloc(_t([0]), _t([16]))
    donor = c.table.numpy()[0].copy()
    k = _write_rows(c, [0])
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, :2] = donor[:2]
    c.alloc(_t([1]), _t([16]), shared=_t(shared))
    t1 = c.table.numpy()[1]
    assert t1[0] == donor[0] and t1[1] == donor[1] and (t1 >= 0).all()
    rc = c.refcount.numpy()
    assert rc[donor[0]] == 2 and rc[donor[1]] == 2
    np.testing.assert_array_equal(rc, _refcounts_from_state(c))
    kg, _ = c.view(0).gather()
    np.testing.assert_array_equal(kg[1, :8].numpy(), k[0, :8].numpy())
    assert c.owner.numpy()[donor[0]] == 0 and c.owner.numpy()[donor[1]] == 0


def test_pin_survives_row_free_until_release():
    c = _mk(n_rows=1, max_len=8, block=4, n_blocks=4)
    pin = np.zeros((1, c.blocks_per_row), bool)
    pin[0, 0] = True
    c.alloc(_t([0]), _t([8]), pin=torch.from_numpy(pin))
    b0 = int(c.table[0, 0])
    assert int(c.refcount[b0]) == 2                  # table + pin
    c.free(_t([0]))
    assert int(c.refcount[b0]) == 1                  # the pin holds it
    assert int(c.free_count) == c.n_blocks - 1
    c.release(_t([b0]))
    assert int(c.refcount[b0]) == 0 and int(c.owner[b0]) == -1
    assert int(c.free_count) == c.n_blocks


def test_alloc_all_or_nothing_at_exhaustion():
    """A row that does not fit reserves nothing; a later smaller row still
    allocates."""
    c = _mk(n_rows=3, max_len=12, block=4, n_blocks=4)
    c.alloc(_t([0, 1, 2]), _t([12, 8, 4]))
    table = c.table.numpy()
    assert (table[0] >= 0).sum() == 3
    assert (table[1] == -1).all()
    assert (table[2] >= 0).sum() == 1
    np.testing.assert_array_equal(c.refcount.numpy(),
                                  _refcounts_from_state(c))
    assert int(c.free_count) == 0


def test_alloc_failed_row_maps_no_shared_block():
    c = _mk(n_rows=2, max_len=16, block=4, n_blocks=5)
    c.alloc(_t([0]), _t([16]))
    donor = c.table.numpy()[0].copy()
    before = c.refcount.clone()
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, :2] = donor[:2]
    # row 1 needs 4 blocks, 2 shared + 2 fresh, but only 1 is free
    c.alloc(_t([1]), _t([16]), shared=_t(shared))
    assert (c.table.numpy()[1] == -1).all()
    assert torch.equal(c.refcount, before)


def test_cow_sharer_copies_owner_writes_in_place():
    c = _mk(n_rows=2, max_len=8, block=4, n_blocks=6)
    pin = np.zeros((1, c.blocks_per_row), bool)
    pin[0, 0] = True
    c.alloc(_t([0]), _t([8]), pin=torch.from_numpy(pin))
    k = _write_rows(c, [0])
    donor = c.table.numpy()[0].copy()
    table0 = c.table.clone()
    # the owner writes into its pinned (refcount 2) block: no copy
    c.ensure_private(_t([0]), start=0, width=4)
    assert torch.equal(c.table, table0)
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, 0] = donor[0]
    c.alloc(_t([1]), _t([8]), shared=_t(shared))
    assert int(c.refcount[donor[0]]) == 3
    c.ensure_private(_t([1]), start=0, width=4)
    t1 = c.table.numpy()[1]
    assert t1[0] != donor[0]                          # repointed to a copy
    assert int(c.refcount[donor[0]]) == 2
    assert int(c.refcount[t1[0]]) == 1 and int(c.owner[t1[0]]) == 1
    kg, _ = c.view(0).gather()
    np.testing.assert_array_equal(kg[1, :4].numpy(), k[0, :4].numpy())
    np.testing.assert_array_equal(kg[0].numpy(), k[0].numpy())
    expect = _refcounts_from_state(c)
    expect[donor[0]] += 1                             # the index pin
    np.testing.assert_array_equal(c.refcount.numpy(), expect)


def test_cow_pool_dry_drops_the_write_keeps_shared_bits():
    """No free block for the copy: the sharer's entry becomes -1, so its
    write lands in the TRASH block, and the shared bits survive."""
    c = _mk(n_rows=2, max_len=4, block=4, n_blocks=2)
    c.alloc(_t([0]), _t([4]))
    donor = int(c.table[0, 0])
    k = _write_rows(c, [0])
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, 0] = donor
    c.alloc(_t([1]), _t([0]), shared=_t(shared))
    c.refcount[1 - donor] = max(int(c.refcount[1 - donor]), 1)
    c.ensure_private(_t([1]), start=0, width=4)
    assert int(c.table[1, 0]) == -1 and int(c.refcount[donor]) == 1
    junk = torch.full((1, 4, 2, 8), 7.0)
    c.view(0, rows=_t([1])).write_chunk(junk, junk, _t([0]))
    kg, _ = c.view(0, rows=_t([0])).gather()
    np.testing.assert_array_equal(kg[0].numpy(), k[0].numpy())


def test_cow_masked_rows_do_not_copy():
    c = _mk(n_rows=2, max_len=8, block=4, n_blocks=6)
    c.alloc(_t([0, 1]), _t([8, 0]))
    donor = c.table.numpy()[0].copy()
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, 0] = donor[0]
    c.alloc(_t([1]), _t([8]), shared=_t(shared))
    table = c.table.clone()
    c.ensure_private(_t([0, 1]), start=0, width=4,
                     mask=torch.tensor([False, False]))
    assert torch.equal(c.table, table)
    c.ensure_private(_t([0, 1]), start=0, width=4,
                     mask=torch.tensor([False, True]))
    assert int(c.table[1, 0]) != donor[0]
    np.testing.assert_array_equal(c.refcount.numpy(),
                                  _refcounts_from_state(c))


def test_reclaimable_counts_exclusive_blocks():
    c = _mk(n_rows=3, max_len=12, block=4, n_blocks=9)
    c.alloc(_t([0]), _t([12]))
    donor = c.table.numpy()[0].copy()
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, :2] = donor[:2]
    c.alloc(_t([1]), _t([12]), shared=_t(shared))
    assert c.reclaimable().tolist() == [1, 1, 0]
    dense = kvc.DenseKVCache.create(1, 3, 8, 1, 4, torch.float32, "cpu")
    assert dense.reclaimable().tolist() == [0, 0, 0]


def test_a_cache_without_sharing_refuses_it_and_copies_nothing():
    c = _mk(n_rows=2, max_len=8, block=4, n_blocks=4, sharing=False)
    with pytest.raises(ValueError, match="sharing=True"):
        c.alloc(_t([0]), _t([4]), pin=torch.ones((1, 2), dtype=torch.bool))
    c.alloc(_t([0]), _t([8]))
    c.refcount[int(c.table[0, 0])] = 2        # as if shared
    table, rc = c.table.clone(), c.refcount.clone()
    c.ensure_private(_t([1]), start=0, width=8)
    assert torch.equal(c.table, table) and torch.equal(c.refcount, rc)
    with pytest.raises(ValueError, match="paged"):
        kvc.make_kv_cache(get_config("llama3.2-1b", smoke=True), 1, 2, 8,
                          impl="dense", sharing=True, device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_cache_ops_equal_the_jax_cache(seed):
    """A random sequence of free+alloc (with a pin), free, share, CoW at
    random offsets and widths, and release: after every op the port's
    table, refcount, owner, pools, reclaimable and free count equal the
    JAX cache's."""
    rng = np.random.default_rng(seed)
    L, KV, hd, nr, ml, bl, nb = 2, 2, 4, 3, 12, 4, 8
    j = jkvc.PagedKVCache.create(L, nr, ml, KV, hd, jnp.float32, block=bl,
                                 n_blocks=nb)
    c = _mk(n_rows=nr, max_len=ml, block=bl, n_blocks=nb, L=L, KV=KV, hd=hd)
    pools = rng.standard_normal((L, nb, bl, KV, hd)).astype(np.float32)
    j = j.with_layers({"k": jnp.asarray(pools), "v": jnp.asarray(-pools)})
    c.k_pool[:, :nb] = torch.from_numpy(pools)
    c.v_pool[:, :nb] = torch.from_numpy(-pools)
    bpr = c.blocks_per_row
    for _ in range(12):
        kind, row = int(rng.integers(0, 5)), int(rng.integers(0, nr))
        r = np.array([row], np.int32)
        if kind == 0:
            pin = np.zeros((1, bpr), bool)
            pin[0, 0] = bool(rng.integers(0, 2))
            budget = np.array([4 * int(rng.integers(1, 4))], np.int32)
            j = j.free(jnp.asarray(r)).alloc(jnp.asarray(r),
                                             jnp.asarray(budget),
                                             pin=jnp.asarray(pin))
            c.free(_t(r)).alloc(_t(r), _t(budget), pin=torch.from_numpy(pin))
        elif kind == 1:
            j = j.free(jnp.asarray(r))
            c.free(_t(r))
        elif kind == 2:
            start, width = int(rng.integers(0, 8)), int(rng.integers(1, 6))
            j = j.ensure_private(jnp.asarray(r), start=start, width=width)
            c.ensure_private(_t(r), start=start, width=width)
        elif kind == 3:
            donor = np.asarray(j.table)[int(rng.integers(0, nr))]
            k = int(rng.integers(0, bpr))
            if (donor[:k] < 0).any():
                continue
            shared = np.full((1, bpr), -1, np.int32)
            shared[0, :k] = donor[:k]
            j = j.free(jnp.asarray(r)).alloc(
                jnp.asarray(r), jnp.asarray([ml]), shared=jnp.asarray(shared))
            c.free(_t(r)).alloc(_t(r), _t([ml]), shared=_t(shared))
        else:
            ids = np.array([int(rng.integers(-1, nb))], np.int32)
            j = j.release(jnp.asarray(ids))
            c.release(_t(ids))
        for a, b in ((j.table, c.table), (j.refcount, c.refcount),
                     (j.owner, c.owner), (j.reclaimable(), c.reclaimable())):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(j.k_pool),
                                      c.k_pool[:, :nb].numpy())
        np.testing.assert_array_equal(np.asarray(j.v_pool),
                                      c.v_pool[:, :nb].numpy())
        assert int(j.free_count) == int(c.free_count)


# -------------------------------------------------------- property tests

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

# (kind, row, blocks): 0 = free + alloc with a pin on column 0, 1 = free,
# 2 = CoW over the leading blocks
_OPS = st.lists(st.tuples(st.integers(0, 2), st.integers(0, 2),
                          st.integers(1, 3)), min_size=1, max_size=6)


@settings(max_examples=20, deadline=None)
@given(ops=_OPS)
def test_property_refcounts_equal_tables_plus_pins(ops):
    c = _mk(n_rows=3, max_len=12, block=4, n_blocks=8)
    pins = np.zeros(c.n_blocks, np.int64)
    for kind, row, blocks in ops:
        r = _t([row])
        if kind == 0:
            pin = torch.zeros((1, c.blocks_per_row), dtype=torch.bool)
            pin[0, 0] = True
            c.free(r).alloc(r, _t([blocks * 4]), pin=pin)
            got = int(c.table[row, 0])
            if got >= 0:
                pins[got] += 1
        elif kind == 1:
            c.free(r)
        else:
            c.ensure_private(r, start=0, width=blocks * 4)
        rc = c.refcount.numpy()
        np.testing.assert_array_equal(rc, _refcounts_from_state(c) + pins)
        assert int(c.free_count) == int((rc == 0).sum())
        table, owner = c.table.numpy(), c.owner.numpy()
        for bid in np.nonzero(rc == 0)[0]:
            assert not (table == bid).any() and owner[bid] == -1


@settings(max_examples=20, deadline=None)
@given(ops=_OPS)
def test_property_shared_mapping_keeps_refcounts(ops):
    c = _mk(n_rows=3, max_len=12, block=4, n_blocks=8)
    c.alloc(_t([0]), _t([12]))
    shared = np.full((1, c.blocks_per_row), -1, np.int32)
    shared[0, :2] = c.table.numpy()[0, :2]
    c.alloc(_t([1]), _t([12]), shared=_t(shared))
    for kind, row, blocks in ops:
        r = _t([row])
        if kind == 0:
            c.free(r).alloc(r, _t([blocks * 4]))
        elif kind == 1:
            c.free(r)
        else:
            c.ensure_private(r, start=0, width=blocks * 4)
        rc = c.refcount.numpy()
        np.testing.assert_array_equal(rc, _refcounts_from_state(c))
        assert int(c.free_count) == int((rc == 0).sum())


@functools.lru_cache(maxsize=None)
def _pair(arch="llama3.2-1b", seed=2):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


_SHARED = {}


def _shared_sched():
    """One scheduler across the hypothesis examples."""
    if not _SHARED:
        _, _, cfg, params = _pair()
        rng = np.random.default_rng(21)
        _SHARED["pool"] = [rng.integers(2, cfg.vocab, 14).astype(np.int32)
                           for _ in range(3)]
        _SHARED["sched"] = sched_lib.DecodeScheduler(
            params, cfg, n_slots=2, prompt_len=16, max_new_cap=4, eos_id=1,
            kv="paged", kv_block=4, kv_blocks=14, prefill="chunked",
            chunk_tokens=4, prefix_cache=True)
    return _SHARED["sched"], _SHARED["pool"]


def _device_free(sched):
    return int(sched.pool.cache["attn"].free_count)


@settings(max_examples=8, deadline=None)
@given(picks=st.lists(st.integers(0, 2), min_size=1, max_size=4))
def test_property_host_mirror_equals_device_after_every_round(picks):
    sched, pool = _shared_sched()
    assert sched.pending == 0
    for p in picks:
        sched.submit(pool[p][None], max_new=4)
    while sched.pending:
        before = sched.pending
        sched.step()
        assert sched.free_blocks == _device_free(sched)
        assert before >= sched.pending
    assert sched.free_blocks == sched.kv_blocks - len(sched._prefix_index)


# ------------------------------------------------ the scheduler against JAX

KW = dict(n_slots=2, prompt_len=16, max_new_cap=6, eos_id=1, kv="paged",
          kv_block=4, prefill="chunked", chunk_tokens=5)


def _traffic(cfg, kind):
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(2, cfg.vocab, 16).astype(np.int32)
               for _ in range(3))
    if kind == "hits":      # repeats, a shorter prompt of a's prefix
        return [a, b, a, a, b, a[:13], b], 14
    return [a, b, a, c, b, a[:13], c, a], 9     # a pool that evicts


def _rounds(mod, params, cfg, prompts, kv_blocks):
    """Drive to drained, recording after every round (hits, evictions,
    the block table, the host free-block mirror)."""
    sched = mod.DecodeScheduler(params, cfg, kv_blocks=kv_blocks,
                                prefix_cache=True, **KW)
    for rid, p in enumerate(prompts):
        sched.submit(p[None], max_new=6, request_id=rid)
    out, rounds = {}, []
    while sched.pending:
        for f in sched.step():
            out[f.request_id] = np.asarray(f.tokens)
        rounds.append((sched.prefix_hit_blocks, sched.prefix_evictions,
                       np.asarray(sched.pool.cache["attn"].table).copy(),
                       sched.free_blocks))
        assert len(rounds) < 200
    return out, rounds, sched


@pytest.mark.parametrize("kind", ["hits", "evictions"])
def test_scheduler_equals_the_jax_scheduler(kind):
    jcfg, jp, cfg, params = _pair()
    prompts, kv_blocks = _traffic(cfg, kind)
    jout, jrounds, _ = _rounds(jsched, jp, jcfg, prompts, kv_blocks)
    out, rounds, sched = _rounds(sched_lib, params, cfg, prompts, kv_blocks)
    assert sorted(out) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(out[rid], jout[rid])
    assert len(rounds) == len(jrounds)
    for (jh, je, jt, jf), (h, e, t, f) in zip(jrounds, rounds):
        assert (h, e, f) == (jh, je, jf)
        np.testing.assert_array_equal(t, jt)
    assert rounds[-1][0] > 0
    assert (rounds[-1][1] > 0) == (kind == "evictions")
    assert sched.free_blocks == _device_free(sched) == \
        sched.kv_blocks - len(sched._prefix_index)


# ------------------------------------------------------ inside the port

def _drive(params, cfg, prompts, *, max_new=6, **kw):
    sched = sched_lib.DecodeScheduler(params, cfg, **{**KW, **kw})
    for rid, p in enumerate(prompts):
        sched.submit(p[None], max_new=max_new, request_id=rid)
    out = {}
    while sched.pending:
        for f in sched.step():
            out[f.request_id] = np.asarray(f.tokens)
        assert sched.free_blocks == _device_free(sched)
    return out, sched


@pytest.mark.parametrize("attn", ["gather", "cuda"])
def test_warm_streams_equal_cold_and_cache_off(attn):
    """5 requests (2 prompts, repeated) into 2 slots: the repeats map
    cached blocks, and every stream equals the cache-off run's; through
    the plain version of the block-table kernels too."""
    _, _, cfg, params = _pair()
    cfg = dataclasses.replace(cfg, attn_impl=attn)
    prompts, _ = _traffic(cfg, "hits")
    off, _ = _drive(params, cfg, prompts[:5])
    on, sched = _drive(params, cfg, prompts[:5], prefix_cache=True)
    assert sorted(on) == sorted(off)
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])
    assert sched.prefix_hit_blocks > 0
    assert sched.free_blocks == sched.kv_blocks - len(sched._prefix_index)


def test_warm_admission_skips_the_hit_chunks():
    """plen 16 at block 4: the cap maps 3 blocks, 12 positions, so the
    warm request runs 3 chunks of 4 fewer."""
    _, _, cfg, params = _pair()
    p = np.random.default_rng(5).integers(2, cfg.vocab, 16).astype(np.int32)
    sched = sched_lib.DecodeScheduler(params, cfg, **{
        **KW, "chunk_tokens": 4, "max_new_cap": 4}, prefix_cache=True)
    steps = []
    for _ in range(2):
        sched.submit(p[None], max_new=4)
        sched.run_until_drained()
        steps.append(sched.total_steps)
    assert sched.prefix_hit_blocks == 3
    assert steps[1] == steps[0] - 3


def test_sharing_doubles_residents_at_an_equal_pool():
    """Each request holds 5 blocks (16 + 3 + 1 positions at block 4); a
    pool of 12 holds 2 cold ones, and with the 4 prompt blocks pinned,
    4 warm ones that need 2 fresh blocks each."""
    _, _, cfg, params = _pair()
    p = np.random.default_rng(9).integers(2, cfg.vocab, 16).astype(np.int32)

    def peak(prefix_cache):
        sched = sched_lib.DecodeScheduler(
            params, cfg, n_slots=4, prompt_len=16, max_new_cap=3, eos_id=1,
            kv="paged", kv_block=4, kv_blocks=12, prefill="chunked",
            chunk_tokens=4, prefix_cache=prefix_cache)
        sched.submit(p[None], max_new=3)
        sched.run_until_drained()
        sched.peak_resident = 0
        for _ in range(5):
            sched.submit(p[None], max_new=3)
        sched.run_until_drained()
        return sched.peak_resident

    assert peak(False) == 2
    assert peak(True) >= 4


def test_prefix_cache_requires_chunked_paged():
    _, _, cfg, params = _pair()
    for kv, prefill in (("dense", "chunked"), ("paged", "oneshot")):
        with pytest.raises(ValueError, match="prefix_cache"):
            sched_lib.DecodeScheduler(params, cfg, n_slots=1, prompt_len=8,
                                      max_new_cap=2, kv=kv, prefill=prefill,
                                      prefix_cache=True)


def test_one_host_read_a_segment_beside_the_flag_reads():
    """The registered block ids, ``prefilling`` and ``reclaimable`` come
    with the harvest: a prefix-cache run reads the host once a segment
    plus the host-read loop's one flag read an iteration (and the read
    that ends each segment), exactly as a cache-off run."""
    _, _, cfg, params = _pair()
    prompts, _ = _traffic(cfg, "hits")
    for prefix_cache in (False, True):
        reads0 = device_loop.DeviceLoop.host_reads
        _, sched = _drive(params, cfg, prompts, prefix_cache=prefix_cache)
        assert sched.host_reads == device_loop.DeviceLoop.host_reads - reads0
        assert sched.host_reads == sched.total_steps + 2 * sched.segments


def test_chunked_prefix_cache_and_ngram_speculation_equal_batch_sync():
    """chunked prefill + prefix cache + n-gram speculation, paged, 8
    requests into 2 slots on a pool that evicts: every stream equals
    ``engine.generate_batch_sync``'s (the reference's
    ``test_all_three_paged_bit_identical``, inside the port)."""
    _, _, cfg, params = _pair()
    rng = np.random.default_rng(5)
    uniq = [rng.integers(2, cfg.vocab, 16).astype(np.int32) for _ in range(7)]
    prompts = [uniq[0], uniq[1], uniq[0]] + uniq[2:]
    out, sched = _drive(params, cfg, prompts, max_new=8, max_new_cap=8,
                        kv_blocks=7 * 2 + 6, prefix_cache=True,
                        speculative=spec_lib.SpecConfig(k=3, ngram=2))
    sync = engine.generate_batch_sync(params, cfg, torch.from_numpy(
        np.stack(prompts)), max_new=8, eos_id=1, kv_impl="paged", kv_block=4)
    for rid in range(len(prompts)):
        n = int(sync.lengths[rid])
        np.testing.assert_array_equal(out[rid], sync.tokens[rid, :n].numpy())
    assert sched.prefix_hit_blocks > 0 and sched.prefix_evictions > 0
    assert sched.spec_windows > 0
    assert sched.free_blocks == _device_free(sched) == \
        sched.kv_blocks - len(sched._prefix_index)
