"""The port's serving stack against the JAX package's, and the
invariants of its design pinned inside the port.

Against the JAX package (same weights through ``bridge.from_numpy``,
same numpy inputs, fp32 compute): the paged cache's tables, owners and
refcounts after the same alloc/free calls, the pools after the same
writes, ``generate_batch_sync`` and the chunked paged scheduler's
per-request greedy streams. Inside the port: dense == paged bitwise,
kernel path (the plain versions on the CPU) == gather path, scheduler
== ``generate_batch_sync``, and the kernel path never gathers.
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
from repro.serve import engine as jengine
from repro.serve import kv_cache as jkvc
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import engine, kv_cache as kvc
from repro_torch.serve import sampling
from repro_torch.serve import scheduler as sched_lib

RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(arch="llama3.2-1b", impl=("xla", "gather")):
    """(jax cfg, jax params, port cfg, port params), fp32 compute."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype="float32", attn_impl=impl[0])
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32", attn_impl=impl[1])
    jp = jax.jit(model_zoo.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(2))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


# ------------------------------------------------------------- KV cache

def _paged_pair(n_rows=4, max_len=20, block=4, n_blocks=12):
    j = jkvc.PagedKVCache.create(2, n_rows, max_len, 2, 8, jnp.float32,
                                 block=block, n_blocks=n_blocks)
    t = kvc.PagedKVCache.create(2, n_rows, max_len, 2, 8, torch.float32,
                                "cpu", block=block, n_blocks=n_blocks)
    return j, t


def _same_lifecycle(j, t):
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    np.testing.assert_array_equal(t.owner.numpy(), np.asarray(j.owner))
    np.testing.assert_array_equal(t.refcount.numpy(),
                                  np.asarray(j.refcount))


def test_paged_tables_and_owner_match_jax():
    """alloc (first-fit, all-or-nothing per row), masked alloc through a
    slot permutation, and free, op for op."""
    j, t = _paged_pair()
    steps = [
        ("alloc", [0, 1, 2, 3], [9, 20, 5, 13], [1, 1, 1, 1]),  # row 3 fails
        ("free", [0, 1, 2, 3], None, [0, 1, 0, 0]),
        ("alloc", [3, 1, 0, 2], [13, 7, 0, 0], [1, 1, 0, 0]),
        ("free", None, None, [1, 0, 0, 1]),
        ("alloc", [0, 3, 1, 2], [16, 4, 3, 3], [1, 1, 0, 0]),
        ("free", None, None, [1, 1, 1, 1]),
        ("free", None, None, [1, 1, 1, 1]),                     # idempotent
    ]
    for op, rows, budget, mask in steps:
        m = np.array(mask, bool)
        r = None if rows is None else np.array(rows, np.int32)
        if op == "alloc":
            b = np.array(budget, np.int32)
            j = j.alloc(jnp.asarray(r), jnp.asarray(b), mask=jnp.asarray(m))
            t.alloc(_t(r), _t(b), mask=_t(m))
        else:
            j = j.free(None if r is None else jnp.asarray(r),
                       mask=jnp.asarray(m))
            t.free(None if r is None else _t(r), mask=_t(m))
        _same_lifecycle(j, t)


def test_paged_writes_match_jax():
    """write_chunk (lanes past the allocation, a masked row, a chunk
    running off the table) and append land on the same pool lanes; the
    port's extra trash block takes every write the JAX package drops."""
    j, t = _paged_pair()
    rows, budget = np.arange(4, dtype=np.int32), np.array([6, 20, 9, 3],
                                                          np.int32)
    j = j.alloc(jnp.asarray(rows), jnp.asarray(budget))
    t.alloc(_t(rows), _t(budget))
    jv, tv = j.view_at(1), t.view(1, mask=_t(np.array([1, 1, 0, 1], bool)))
    jv = dataclasses.replace(jv, mask=jnp.asarray([True, True, False,
                                                   True]))
    k, v = RNG.standard_normal((2, 4, 7, 2, 8)).astype(np.float32)
    off = np.array([0, 15, 2, 1], np.int32)
    jv = jv.write_chunk(k, v, off)
    tv.write_chunk(_t(k), _t(v), _t(off))
    k1, v1 = RNG.standard_normal((2, 4, 1, 2, 8)).astype(np.float32)
    cur = np.array([7, 20, 5, 4], np.int32)
    jv = jv.append(k1, v1, cur)
    tv.append(_t(k1), _t(v1), _t(cur))
    nb = t.n_blocks
    np.testing.assert_array_equal(t.k_pool[1, :nb].numpy(),
                                  np.asarray(jv.k_pool))
    np.testing.assert_array_equal(t.v_pool[1, :nb].numpy(),
                                  np.asarray(jv.v_pool))
    kg, vg = tv.gather()
    jkg, _ = jv.gather()
    live = np.arange(20)[None] < np.minimum(cur, budget)[:, None]
    np.testing.assert_array_equal(kg.numpy()[live], np.asarray(jkg)[live])


def test_dense_writes_match_jax():
    j = jkvc.DenseKVCache.create(1, 3, 10, 2, 8, jnp.float32)
    t = kvc.DenseKVCache.create(1, 3, 10, 2, 8, torch.float32, "cpu")
    mask = np.array([1, 0, 1], bool)
    jv = j.view(jax.tree.map(lambda a: a[0], j.layers),
                mask=jnp.asarray(mask))
    tv = t.view(0, mask=_t(mask))
    k, v = RNG.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    off = np.array([0, 3, 8], np.int32)                   # last overflows
    jv = jv.write_chunk(k, v, off)
    tv.write_chunk(_t(k), _t(v), _t(off))
    k1, v1 = RNG.standard_normal((2, 3, 1, 2, 8)).astype(np.float32)
    jv = jv.append(k1, v1, np.array([2, 5, 10], np.int32))
    tv.append(_t(k1), _t(v1), _t(np.array([2, 5, 10], np.int32)))
    np.testing.assert_array_equal(t.k[0, :3].numpy(), np.asarray(jv.k))
    np.testing.assert_array_equal(t.v[0, :3].numpy(), np.asarray(jv.v))


# ------------------------------------------------- engine and scheduler

@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_generate_batch_sync_matches_jax(kv):
    jcfg, jp, cfg, tp = _pair()
    prompt = RNG.integers(2, cfg.vocab, (3, 9)).astype(np.int32)
    ref = jengine.generate_batch_sync(jp, jcfg, jnp.asarray(prompt),
                                      max_new=8, eos_id=1, kv_impl=kv,
                                      kv_block=4)
    toks = np.asarray(ref.tokens)
    eos = int(toks[0, 3])      # an EOS that row 0 hits mid-stream
    ref = jengine.generate_batch_sync(jp, jcfg, jnp.asarray(prompt),
                                      max_new=8, eos_id=eos, kv_impl=kv,
                                      kv_block=4)
    ours = engine.generate_batch_sync(tp, cfg, _t(prompt), max_new=8,
                                      eos_id=eos, kv_impl=kv, kv_block=4)
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(ours.text_lengths.numpy(),
                                  np.asarray(ref.text_lengths))
    assert ours.steps == int(ref.steps)
    assert ours.attn_impl == f"gather:{kv}"
    assert ours.prefill_impl == "dense-bucketed"


REQS = [(9, 7), (4, 3), (12, 8), (1, 5), (7, 6)]   # (prompt len, max_new)


def _prompts(cfg):
    rng = np.random.default_rng(5)
    return [(rng.integers(2, cfg.vocab, (1, n)).astype(np.int32), m)
            for n, m in REQS]


def _run_port(tp, cfg, reqs, **kw):
    kw = {"n_slots": 2, "prompt_len": 12, "max_new_cap": 8, "eos_id": 1,
          "kv": "paged", "kv_block": 4, "prefill": "chunked",
          "chunk_tokens": 5, **kw}
    sched = sched_lib.DecodeScheduler(tp, cfg, **kw)
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}, \
        sched


@pytest.mark.parametrize("impl", [("pallas", "cuda"), ("xla", "gather")])
def test_chunked_scheduler_matches_jax_scheduler(impl):
    """2 slots, 5 requests of mixed lengths (queueing, ragged last
    chunks, slot reuse): per-request greedy streams equal the JAX
    scheduler's."""
    jcfg, jp, cfg, tp = _pair("qwen2-7b", impl)
    reqs = _prompts(cfg)
    js = jsched.DecodeScheduler(jp, jcfg, n_slots=2, prompt_len=12,
                                max_new_cap=8, eos_id=1, kv="paged",
                                kv_block=4, prefill="chunked",
                                chunk_tokens=5)
    for rid, (p, m) in enumerate(reqs):
        js.submit(p, max_new=m, request_id=rid)
    ref = {f.request_id: f.tokens for f in js.run_until_drained()}
    ours, sched = _run_port(tp, cfg, reqs)
    assert sorted(ours) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sched.total_steps == js.total_steps
    assert sched.occupancy == pytest.approx(js.occupancy)


def _sync_streams(tp, cfg, reqs):
    """Each request alone through generate_batch_sync, cut at its own
    max_new (greedy streams do not depend on the batch)."""
    out = {}
    for rid, (p, m) in enumerate(reqs):
        r = engine.generate_batch_sync(tp, cfg, _t(p), max_new=m, eos_id=1)
        out[rid] = r.tokens[0, :int(r.lengths[0])].numpy()
    return out


@pytest.mark.parametrize("chunk", [3, 16])
def test_scheduler_equals_generate_batch_sync(chunk):
    _, _, cfg, tp = _pair()
    reqs = _prompts(cfg)
    ours, _ = _run_port(tp, cfg, reqs, chunk_tokens=chunk)
    ref = _sync_streams(tp, cfg, reqs)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])


def test_tight_pool_queues_head_of_line_and_stays_exact():
    """A pool with room for one request at a time: later requests wait
    for blocks (FIFO), and every stream is unchanged."""
    _, _, cfg, tp = _pair()
    reqs = _prompts(cfg)
    ours, sched = _run_port(tp, cfg, reqs, kv_blocks=6)
    ref = _sync_streams(tp, cfg, reqs)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sched.free_blocks == 6


def test_dense_equals_paged_bitwise():
    """The paged gather reconstructs the dense layout lane for lane, so
    the two caches give bitwise-equal logits and streams."""
    _, _, cfg, tp = _pair()
    prompts = RNG.integers(2, cfg.vocab, (2, 10)).astype(np.int32)
    logits = {}
    for kv in ("dense", "paged"):
        cache = engine.make_cache(cfg, 2, 16, kv_impl=kv, kv_block=4,
                                  device="cpu")
        cache["attn"].alloc(torch.arange(2), torch.full((2,), 16))
        logits[kv] = [engine.prefill_chunk(
            tp, cfg, _t(prompts), cache, _t(np.array([o, o], np.int32)),
            chunk=5) for o in (0, 5)]
        logits[kv].append(engine.decode_step(
            tp, cfg, _t(prompts[:, :1]), cache, 11))
    for a, b in zip(logits["dense"], logits["paged"]):
        assert torch.equal(a, b)
    reqs = _prompts(cfg)
    dense, _ = _run_port(tp, cfg, reqs, kv="dense")
    paged, _ = _run_port(tp, cfg, reqs, kv="paged")
    for rid in dense:
        np.testing.assert_array_equal(dense[rid], paged[rid])


def test_kernel_path_equals_gather_path_and_never_gathers():
    """attn_impl cuda (the kernels' plain versions on the CPU) against
    the gather path: identical greedy streams; and the kernel path never
    reconstructs the dense layout."""
    _, _, cfg, tp = _pair()
    reqs = _prompts(cfg)
    gather, _ = _run_port(tp, cfg, reqs)
    before = kvc.PagedView.gather_calls
    kernel, sched = _run_port(tp, dataclasses.replace(cfg, attn_impl="cuda"),
                              reqs)
    assert kvc.PagedView.gather_calls == before
    assert sched.attn_impl == "torch-plain-paged:cpu"
    assert sched.prefill_impl == "torch-plain-flash-paged:cpu"
    for rid in gather:
        np.testing.assert_array_equal(kernel[rid], gather[rid])


# ------------------------------------------------------------ the edges

def test_greedy_takes_the_first_maximal_index():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    keys = torch.zeros((2, 2), dtype=torch.int64)   # unused under greedy
    got = sampling.sample_slots(logits, keys, sampling.SamplingParams())
    assert got.tolist() == [1, 0]
    assert got.tolist() == np.asarray(jnp.argmax(logits.numpy(),
                                                 axis=-1)).tolist()


def test_resolved_paths_name_what_runs():
    cfg = get_config("llama3.2-1b", smoke=True)
    kcfg = dataclasses.replace(cfg, attn_impl="cuda")
    assert engine.resolved_attn_impl(kcfg, "paged", "cuda") == \
        "cuda-paged:sm_90a"
    assert engine.resolved_attn_impl(kcfg, "paged", "cpu") == \
        "torch-plain-paged:cpu"
    assert engine.resolved_attn_impl(kcfg, "dense", "cuda") == "gather:dense"
    assert engine.resolved_attn_impl(kcfg, "paged", "cuda", verify=True) == \
        "cuda-verify-paged:sm_90a"
    assert engine.resolved_attn_impl(kcfg, "paged", "cpu", verify=True) == \
        "torch-plain-verify-paged:cpu"
    assert engine.resolved_attn_impl(cfg, "paged", "cuda") == "gather:paged"
    assert engine.resolved_prefill_impl(kcfg, "paged", "chunked",
                                        "cuda") == "cuda-flash-paged:sm_90a"
    assert engine.resolved_prefill_impl(cfg, "paged", "chunked",
                                        "cpu") == "gather-chunked"
    assert engine.resolved_prefill_impl(kcfg, "paged", "oneshot",
                                        "cuda") == "dense-bucketed"
    scfg = get_config("falcon-mamba-7b", smoke=True)
    for kv in ("dense", "paged"):
        assert engine.resolved_attn_impl(scfg, kv, "cuda") == \
            "attention-free"
        for mode in ("oneshot", "chunked"):
            assert engine.resolved_prefill_impl(scfg, kv, mode, "cpu") == \
                "attention-free"


def test_scheduler_rejects_what_it_cannot_serve():
    _, _, cfg, tp = _pair()
    sched = sched_lib.DecodeScheduler(tp, cfg, n_slots=1, prompt_len=4,
                                      max_new_cap=4, kv="paged",
                                      kv_block=4, kv_blocks=2)
    with pytest.raises(ValueError):
        sched.submit(np.ones((1, 5), np.int32), max_new=2)
    with pytest.raises(ValueError):
        sched.submit(np.ones((1, 4), np.int32), max_new=5)
    with pytest.raises(ValueError, match="kv_blocks"):
        sched.submit(np.ones((1, 4), np.int32), max_new=4)   # 3 blocks
    with pytest.raises(ValueError, match="oneshot"):
        sched_lib.DecodeScheduler(tp, cfg, n_slots=1, prompt_len=4,
                                  max_new_cap=4, prefill="streamed")
    with pytest.raises(ValueError, match="admit_threshold"):
        sched_lib.DecodeScheduler(tp, cfg, n_slots=2, prompt_len=4,
                                  max_new_cap=4, admit_threshold=3)


def test_launcher_runs_on_cpu_when_asked():
    # every arrival lands before the first step: the scheduler resets its
    # counters whenever work reaches a drained pool, so a gap between
    # arrivals would split the count
    out = launch_serve.main(
        ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--slots",
         "2", "--prompt-len", "8", "--requests", "3", "--rate", "1e9",
         "--max-new-short", "3", "--max-new-long", "5", "--kv", "paged",
         "--attn-impl", "cuda", "--prefill", "chunked", "--chunk-tokens",
         "4", "--eos-id", "-1"])
    assert out["tokens"] == 3 + 5 + 3
    assert out["attn_impl"] == "torch-plain-paged:cpu"
    assert out["prefill_impl"] == "torch-plain-flash-paged:cpu"
