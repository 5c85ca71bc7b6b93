"""Prefill/decode disaggregation in the port (``serve/disagg.py``, the
scheduler's tier hooks, ``PagedKVCache.export_rows``/``import_rows``)
against the JAX package's and against the port's colocated scheduler.

Tolerances: none. Block shipping moves bits (export, round trip and
masked import: equal to the JAX cache's, element for element), and the
disaggregated greedy streams equal the colocated scheduler's token for
token (a placement change), in the port and against the JAX
``DisaggScheduler`` in fp32 on its own test's fixtures (smollm smoke,
block 4, chunk 5), with ``replay_mismatches == 0`` under preemption.

Also here: the repair of the read outside the harvest (without the
prefix cache ``reclaimable_host`` reads nothing after an admission, a
splice or a preemption, and equals the device's ``reclaimable``), the
refusals (a model drafter, a mesh, ``--prefill-devices 2``), and the
launcher's ``--disagg`` report. The tests marked ``cuda`` run the side
stream ship on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_disagg.py

JAX is imported only inside the tests that hold the port to it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import disagg as disagg_lib
from repro_torch.serve import engine
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib

LENS = (3, 5, 9, 16, 1, 12)     # the reference test's prompt lengths


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.serve import disagg as jdisagg
    from repro.serve import engine as jengine
    from repro.serve import scheduler as jsched
    return dict(jax=jax, jnp=jnp, get_config=jax_get_config, zoo=jzoo,
                disagg=jdisagg, engine=jengine, sched=jsched)


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax cfg, jax params, port cfg, port params): smollm smoke in
    fp32, the JAX package's draws at the reference test's key on both
    sides."""
    J = _jax()
    jcfg = dataclasses.replace(J["get_config"]("smollm-135m", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              compute_dtype="float32")
    jparams = J["zoo"].init_params(jcfg, J["jax"].random.PRNGKey(3))
    params = bridge.from_numpy(J["jax"].tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, lens=LENS):
    J = _jax()
    key = J["jax"].random.PRNGKey(3)
    return [np.asarray(J["jax"].random.randint(
        J["jax"].random.fold_in(key, b), (1, L), 2, cfg.vocab), np.int32)
        for b, L in enumerate(lens)]


def _tokens(finished):
    return {f.request_id: np.asarray(f.tokens) for f in finished}


def _colocated(mod, params, cfg, prompts, *, max_new=6, prompt_len=16,
               n_slots=2, prefix_cache=False):
    sched = mod.DecodeScheduler(
        params, cfg, n_slots=n_slots, prompt_len=prompt_len,
        max_new_cap=max_new, eos_id=1, kv="paged", kv_block=4,
        prefill="chunked", chunk_tokens=5, prefix_cache=prefix_cache)
    for b, p in enumerate(prompts):
        sched.submit(p, max_new=max_new, request_id=b)
    return _tokens(sched.run_until_drained()), sched


def _disagg(mod, params, cfg, prompts, *, max_new=6, prompt_len=16,
            n_decode_slots=2, **kw):
    d = mod.DisaggScheduler(
        params, cfg, n_prefill_slots=2, n_decode_slots=n_decode_slots,
        prompt_len=prompt_len, max_new_cap=max_new, eos_id=1, kv_block=4,
        chunk_tokens=5, **kw)
    for b, p in enumerate(prompts):
        d.submit(p, max_new=max_new, request_id=b)
    return _tokens(d.run_until_drained()), d


def _assert_same(got, ref):
    assert got.keys() == ref.keys()
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=str(rid))


def _drained(d):
    assert d.prefill.free_blocks == d.prefill.kv_blocks
    assert d.decode.free_blocks == d.decode.kv_blocks
    for tier in (d.prefill, d.decode):
        node = tier.pool.cache[tier._kv_key]
        assert int((node.refcount == 0).sum()) == tier.kv_blocks
        assert bool((node.table == -1).all())


# ------------------------------------------------------ the wire format

def _caches(rows, max_len, block, lens):
    """The same allocated paged cache in both packages, random pools."""
    J = _jax()
    jcfg, _, cfg, _ = _pair()
    key = J["engine"].kv_key(jcfg)
    jc = J["engine"].make_cache(jcfg, rows, max_len, kv_impl="paged",
                                kv_block=block)[key]
    jc = jc.alloc(J["jnp"].arange(rows, dtype=J["jnp"].int32),
                  J["jnp"].asarray(lens, J["jnp"].int32))
    rng = np.random.default_rng(0)
    kp = rng.normal(size=jc.k_pool.shape).astype(np.float32)
    vp = rng.normal(size=jc.v_pool.shape).astype(np.float32)
    jc = dataclasses.replace(jc, k_pool=J["jnp"].asarray(kp),
                             v_pool=J["jnp"].asarray(vp))
    tc = engine.make_cache(cfg, rows, max_len, kv_impl="paged",
                           kv_block=block, device="cpu")[key]
    tc.alloc(torch.arange(rows), torch.tensor(lens))
    tc.k_pool[:, :-1] = torch.from_numpy(kp)
    tc.v_pool[:, :-1] = torch.from_numpy(vp)
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
    return jc, tc


def test_export_equals_jax_and_round_trips():
    """``export_rows`` equals the JAX cache's (dead tail columns zero);
    importing into a second pool and exporting again gives the same
    bits (the reference test's round trip)."""
    rows, max_len, block = 3, 16, 4
    jc, tc = _caches(rows, max_len, block, [16, 7, 12])
    n_cols = kvc.blocks_needed(max_len, block)
    jk, jv = jc.export_rows(np.arange(rows, dtype=np.int32), n_cols)
    k, v = tc.export_rows(torch.arange(rows), n_cols)
    assert k.shape == (tc.k_pool.shape[0], rows, n_cols, block,
                       tc.k_pool.shape[3], tc.k_pool.shape[4])
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # fresh: no aliasing into the pool
    assert k.data_ptr() != tc.k_pool.data_ptr()
    tc.k_pool.zero_()
    assert k.abs().sum() > 0
    # row 1 holds ceil(7 / 4) = 2 columns: its third is dead zeros
    assert not k[:, 1, 2].any()
    cfg, key = _pair()[2], "attn"
    dst = engine.make_cache(cfg, rows, max_len, kv_impl="paged",
                            kv_block=block, device="cpu")[key]
    dst.alloc(torch.arange(rows), torch.tensor([16, 7, 12]))
    dst.import_rows(torch.arange(rows), k, v)
    k2, v2 = dst.export_rows(torch.arange(rows), n_cols)
    torch.testing.assert_close(k2, k, rtol=0, atol=0)
    torch.testing.assert_close(v2, v, rtol=0, atol=0)


def test_import_masked_rows_untouched_as_jax():
    """An unmasked row's blocks keep their bits (the reference test);
    the port's pools equal the JAX cache's after the same import."""
    J = _jax()
    rows, max_len, block = 2, 8, 4
    jc, tc = _caches(rows, max_len, block, [8, 8])
    n_cols = kvc.blocks_needed(max_len, block)
    ones = np.ones((tc.k_pool.shape[0], rows, n_cols, block,
                    tc.k_pool.shape[3], tc.k_pool.shape[4]), np.float32)
    before = tc.k_pool.clone()
    jout = jc.import_rows(np.arange(rows, dtype=np.int32), ones, ones,
                          mask=J["jnp"].asarray([True, False]))
    tc.import_rows(torch.arange(rows), torch.from_numpy(ones),
                   torch.from_numpy(ones), mask=torch.tensor([True, False]))
    t = tc.table.numpy()
    np.testing.assert_array_equal(tc.k_pool[:, t[1, :n_cols]].numpy(),
                                  before[:, t[1, :n_cols]].numpy())
    assert bool((tc.k_pool[:, t[0, :n_cols]] == 1.0).all())
    np.testing.assert_array_equal(tc.k_pool[:, :-1].numpy(),
                                  np.asarray(jout.k_pool))


def test_dense_cache_ships_nothing():
    _, _, cfg, _ = _pair()
    dense = engine.make_cache(cfg, 2, 8, kv_impl="dense",
                              device="cpu")["attn"]
    with pytest.raises(NotImplementedError):
        dense.export_rows(torch.arange(2), 2)
    with pytest.raises(NotImplementedError):
        dense.import_rows(torch.arange(2), None, None)


# ------------------------------------------------ against colocation

def test_disagg_equals_colocated_dense():
    _, _, cfg, params = _pair()
    prompts = _prompts(cfg)
    ref, co = _colocated(sched_lib, params, cfg, prompts)
    got, d = _disagg(disagg_lib, params, cfg, prompts)
    _assert_same(got, ref)
    assert co.transfer_impl == "colocated"
    assert d.transfer_impl == "torch-copy:cpu"
    assert d.transfers == len(prompts) and d.transfer_bytes > 0
    assert d.replay_mismatches == 0 and d.completed == len(prompts)
    assert d.prefill_steps > 0 and d.total_steps > 0
    _drained(d)


def test_disagg_prefix_cache_equals_colocated():
    """The prefix cache lives on the prefill tier: warm repeats hit
    there, the decode tier gets private copies, the streams stay
    equal."""
    _, _, cfg, params = _pair()
    a, b = _prompts(cfg, (16, 16))
    prompts = [a, b, a, a, b]
    ref, _ = _colocated(sched_lib, params, cfg, prompts, prefix_cache=True)
    got, d = _disagg(disagg_lib, params, cfg, prompts, prefix_cache=True)
    _assert_same(got, ref)
    assert d.prefill.prefix_hit_blocks > 0
    assert d.decode.prefix_hit_blocks == 0 and not d.decode.prefix_cache
    # the pins stay on the prefill tier; the decode tier drains
    assert d.decode.free_blocks == d.decode.kv_blocks
    pins = len(d.prefill._prefix_index)
    assert d.prefill.free_blocks == d.prefill.kv_blocks - pins


def test_disagg_ngram_speculation_equals_colocated():
    _, _, cfg, params = _pair()
    base = _prompts(cfg, (4,))[0]
    prompt = np.tile(base, (1, 4))        # self-repeating: the n-gram hits
    spec = spec_lib.SpecConfig(k=3, drafter="ngram", ngram=2)
    ref, _ = _colocated(sched_lib, params, cfg, [prompt], max_new=8)
    got, d = _disagg(disagg_lib, params, cfg, [prompt], max_new=8,
                     speculative=spec)
    _assert_same(got, ref)
    assert d.decode.drafted_tokens > 0
    _drained(d)


def _contended(mod, params, cfg, prompts):
    """The reference test's contention: two batch-class residents fill
    the decode tier (7 blocks each of 14), then an urgent arrival."""
    d = mod.DisaggScheduler(
        params, cfg, n_prefill_slots=1, n_decode_slots=2, prompt_len=16,
        max_new_cap=16, eos_id=1, kv_block=4, chunk_tokens=5,
        decode_kv_blocks=14, segment_steps=2, prefill_segment_steps=4)
    d.submit(prompts[0], max_new=8, request_id=0, priority=1)
    d.submit(prompts[1], max_new=8, request_id=1, priority=1)
    done = []
    for _ in range(3):
        done += d.step(max_steps=2)
    assert d.decode.active_count == 2 and not done
    d.submit(prompts[2], max_new=4, request_id=2, priority=0)
    done += d.run_until_drained()
    return _tokens(done), d


def test_disagg_preemption_replays_bit_identical():
    _, _, cfg, params = _pair()
    prompts = _prompts(cfg, (16, 16, 16))
    got, d = _contended(disagg_lib, params, cfg, prompts)
    assert d.preemptions >= 1 and d.replay_mismatches == 0
    assert got.keys() == {0, 1, 2}
    for rid, max_new in ((0, 8), (1, 8), (2, 4)):
        ref = engine.generate_batch_sync(
            params, cfg, torch.tensor(prompts[rid]), max_new=max_new,
            eos_id=1)
        np.testing.assert_array_equal(
            got[rid], ref.tokens[0, :len(got[rid])].numpy())
    _drained(d)


# ------------------------------------------------ against the reference

def test_disagg_equals_jax_disagg():
    J = _jax()
    jcfg, jparams, cfg, params = _pair()
    prompts = _prompts(cfg)
    want, jd = _disagg(J["disagg"], jparams, jcfg, prompts)
    got, d = _disagg(disagg_lib, params, cfg, prompts)
    _assert_same(got, want)
    assert d.transfers == jd.transfers
    assert d.transfer_bytes == jd.transfer_bytes
    assert d.total_steps == jd.total_steps


def test_disagg_preemption_equals_jax():
    J = _jax()
    jcfg, jparams, cfg, params = _pair()
    prompts = _prompts(cfg, (16, 16, 16))
    want, jd = _contended(J["disagg"], jparams, jcfg, prompts)
    got, d = _contended(disagg_lib, params, cfg, prompts)
    _assert_same(got, want)
    assert d.preemptions == jd.preemptions
    assert d.replay_mismatches == jd.replay_mismatches == 0


# ------------------------------------------------ the tier hooks

def test_prefill_tier_hooks():
    """A prefill-only tier retires rows DONE holding their blocks; the
    harvest brings the first token and the prompt length in its one read;
    release frees them."""
    _, _, cfg, params = _pair()
    prompts = _prompts(cfg, (9, 3))
    pf = sched_lib.DecodeScheduler(
        params, cfg, n_slots=2, prompt_len=16, max_new_cap=1, eos_id=1,
        kv="paged", kv_block=4, prefill="chunked", chunk_tokens=5,
        prefill_only=True)
    for b, p in enumerate(prompts):
        pf.submit(p, max_new=1, request_id=b)
    assert pf.dispatch_segment() and pf.segment_done()
    reads = pf.host_reads
    recs = pf.harvest_prefilled()
    assert pf.host_reads == reads + 1
    assert sorted(r["plen"] for r in recs) == [3, 9]
    assert pf.active_count == 2 and pf.free_blocks < pf.kv_blocks
    ref, _ = _colocated(sched_lib, params, cfg, prompts, max_new=1)
    for r in recs:
        assert r["t0"] == int(ref[r["req"].request_id][0])
    pf.release_slots([r["slot"] for r in recs])
    assert pf.active_count == 0 and pf.free_blocks == pf.kv_blocks
    with pytest.raises(ValueError, match="not resident"):
        pf.release_slots([0])
    with pytest.raises(RuntimeError, match="decode tier"):
        pf.splice_requests(recs, [0, 0], [1, 1], None, None)
    colo = sched_lib.DecodeScheduler(
        params, cfg, n_slots=2, prompt_len=16, max_new_cap=2, kv="paged",
        kv_block=4, prefill="chunked", chunk_tokens=5)
    with pytest.raises(RuntimeError, match="prefill_only"):
        colo.harvest_prefilled()
    for bad in (dict(prefill="oneshot"), dict(kv="dense"),
                dict(speculative=spec_lib.SpecConfig(k=2))):
        kw = {**dict(kv="paged", prefill="chunked"), **bad}
        with pytest.raises(ValueError, match="prefill_only|prefill-only"):
            sched_lib.DecodeScheduler(params, cfg, n_slots=2, prompt_len=16,
                                      max_new_cap=1, prefill_only=True, **kw)


# ------------------------------------------------ the repair

def _paged(params, cfg, prefix_cache=False):
    return sched_lib.DecodeScheduler(
        params, cfg, n_slots=3, prompt_len=16, max_new_cap=6, eos_id=-1,
        kv="paged", kv_block=4, prefill="chunked", chunk_tokens=5,
        prefix_cache=prefix_cache)


def _device_reclaim(sched):
    return sched.pool.cache[sched._kv_key].reclaimable().numpy()


def test_reclaimable_host_reads_nothing_without_the_prefix_cache():
    """After an admission, a splice and a preemption without the prefix
    cache, ``reclaimable_host`` adds no host read and equals the
    device's ``reclaimable``."""
    _, _, cfg, params = _pair()
    prompts = _prompts(cfg, (16, 9, 5))
    sched = _paged(params, cfg)
    sched.submit(prompts[0], max_new=6, request_id=0)
    sched.step(max_steps=1)
    sched.submit(prompts[1], max_new=6, request_id=1)
    sched._admit_queued()                          # an admission
    reads = sched.host_reads
    np.testing.assert_array_equal(sched.reclaimable_host(),
                                  _device_reclaim(sched))
    # a splice: a shipment from a second pool
    d = disagg_lib.DisaggScheduler(
        params, cfg, n_prefill_slots=1, n_decode_slots=1, prompt_len=16,
        max_new_cap=6, eos_id=-1, kv_block=4, chunk_tokens=5)
    d.submit(prompts[2], max_new=6, request_id=2)
    d.prefill.queue.extend(d.queue)
    d.prefill.dispatch_segment(max_steps=8)
    (rec,) = d.prefill.harvest_prefilled()
    k, v = d.prefill.pool.cache["attn"].export_rows(
        torch.tensor([rec["slot"]]), 4)
    q = dataclasses.replace(rec["req"], max_new=6)
    sched.splice_requests([q], [rec["t0"]], [rec["plen"]], k, v)
    np.testing.assert_array_equal(sched.reclaimable_host(),
                                  _device_reclaim(sched))
    sched.preempt_slots([1])                       # a preemption
    np.testing.assert_array_equal(sched.reclaimable_host(),
                                  _device_reclaim(sched))
    assert sched.host_reads == reads


def test_reclaimable_host_still_reads_with_the_prefix_cache():
    _, _, cfg, params = _pair()
    prompts = _prompts(cfg, (16, 16))
    sched = _paged(params, cfg, prefix_cache=True)
    sched.submit(prompts[0], max_new=6, request_id=0)
    sched.step(max_steps=1)
    sched.submit(prompts[1], max_new=6, request_id=1)
    sched._admit_queued()
    reads = sched.host_reads
    np.testing.assert_array_equal(sched.reclaimable_host(),
                                  _device_reclaim(sched))
    assert sched.host_reads == reads + 1
    sched.reclaimable_host()                       # fresh now: no read
    assert sched.host_reads == reads + 1
    # the preemption reads the admission's registered block ids, and the
    # counts it leaves are read again
    sched.preempt_slots([1])
    assert sched.host_reads == reads + 2
    np.testing.assert_array_equal(sched.reclaimable_host(),
                                  _device_reclaim(sched))
    assert sched.host_reads == reads + 3


# ------------------------------------------------ refusals and launcher

def test_refusals():
    _, _, cfg, params = _pair()
    kw = dict(n_prefill_slots=1, n_decode_slots=2, prompt_len=16,
              max_new_cap=6, kv_block=4, chunk_tokens=5)
    with pytest.raises(ValueError, match="n-gram drafter only"):
        disagg_lib.DisaggScheduler(
            params, cfg, speculative=spec_lib.SpecConfig(k=2,
                                                         drafter="model"),
            draft_params=params, draft_cfg=cfg, **kw)
    with pytest.raises(ValueError, match="both prefill_mesh and decode_"):
        disagg_lib.DisaggScheduler(params, cfg, prefill_mesh=object(), **kw)
    with pytest.raises(ValueError, match="both prefill_mesh and decode_"):
        disagg_lib.DisaggScheduler(params, cfg, decode_mesh=object(), **kw)
    base = ["--arch", "smollm-135m", "--smoke", "--disagg", "--device",
            "cpu", "--requests", "2"]
    # carving prefill ranks needs a job of several ranks
    with pytest.raises(SystemExit, match="this job has one rank"):
        launch_serve.main(base + ["--prefill-devices", "2"])
    with pytest.raises(SystemExit, match="ngram drafter only"):
        launch_serve.main(base + ["--spec-k", "2", "--spec-drafter",
                                  "model", "--draft-arch", "smollm-135m"])


def test_launcher_disagg_report(capsys):
    out = launch_serve.main(
        ["--arch", "smollm-135m", "--smoke", "--slots", "2",
         "--prompt-len", "16", "--requests", "4", "--chunk-tokens", "5",
         "--kv-block", "4", "--disagg", "--prefill-slots", "1",
         "--device", "cpu", "--rate", "1000"])
    text = capsys.readouterr().out
    assert "transfer torch-copy:cpu" in text and "KV shipments" in text
    assert out["tokens"] > 0 and out["replay_mismatches"] == 0


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side stream and CUDA graphs "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_side_stream_ship_on_card(cuda_device):
    """Both tiers in graph segments on the card, the prefill tier on its
    own stream, the ship on a side stream: streams equal the colocated
    scheduler's, one host read a segment on each tier, both pools
    drain."""
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              compute_dtype="float32", attn_impl="cuda",
                              head_dim=64, n_heads=4, n_kv_heads=2,
                              d_model=128)
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, (1, L)).astype(np.int32)
               for L in LENS]
    ref, co = _colocated(sched_lib, params, cfg, prompts)
    got, d = _disagg(disagg_lib, params, cfg, prompts)
    _assert_same(got, ref)
    assert d.transfer_impl == "cuda-copy:side-stream"
    assert d.loop_impl == "cuda-graph:while"
    assert d.prefill._stream != d.decode._stream
    for tier in (d.prefill, d.decode):
        assert tier.host_reads == tier.segments > 0
        assert tier.device_launches["gather"] == 0
    assert d.prefill.device_launches["flash_prefill"] > 0
    assert d.decode.device_launches["paged_attention"] > 0
    assert d.decode.device_launches["flash_prefill"] == 0
    assert d.export_ms > 0
    _drained(d)
    co.close()
    d.close()
