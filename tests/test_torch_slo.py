"""The SLO layer in the port: priority and deadline order, block-level
preemption and its replay, the metrics; against the JAX package and
inside the port.

- Against the JAX package (fp32, the JAX weights through
  ``bridge.from_numpy``, prompts from a numpy seed): on a scripted
  overload (batch traffic on a pool that holds two residents, an
  interactive request injected mid-run), with and without the prefix
  cache, the port's ``SLOScheduler`` gives the JAX one's event sequence
  (kind, request id, tokens: integers, exactly) and the same
  step-clock fields of ``json_summary`` (TTFT and ITL in steps, per
  class, and the counters); the wall-clock fields differ by nature.
- Inside the port (as ``tests/serve/test_slo.py``): a preempted and
  resubmitted request regenerates its uninterrupted stream token for
  token, mid-decode and mid-prefill; its blocks return (host mirror ==
  device free count); ``reclaimable``; the overload end to end;
  priority overtakes a backlog; equal priority never preempts; deadlines
  order a class; preemption on a prefix-cached pool keeps READY pins and
  evicts PENDING ones; a round reads the host no more than the
  scheduler's own round does (the victim order and the emissions come
  from the harvest's read).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo
from repro.serve import scheduler as jsched
from repro.serve import slo as jslo
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import slo as slo_lib

PROMPT, MAX_NEW, BLOCK = 16, 12, 8
NEED = 4                      # ceil((16 + 12 + 1) / 8) blocks a request


@functools.lru_cache(maxsize=None)
def _pair(seed=11):
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32")
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _sched(mod, params, cfg, kv_blocks, **kw):
    return mod.DecodeScheduler(
        params, cfg, n_slots=4, prompt_len=PROMPT, max_new_cap=MAX_NEW,
        eos_id=-1, kv="paged", kv_block=BLOCK, kv_blocks=kv_blocks,
        prefill="chunked", chunk_tokens=8, **kw)


def _prompts(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab, (n, PROMPT)).astype(np.int32)


def _reference(params, cfg, pnp, rids):
    """Uninterrupted FIFO streams of the same requests on a roomy pool."""
    sched = _sched(sched_lib, params, cfg, kv_blocks=None)
    for i, rid in enumerate(rids):
        sched.submit(pnp[i:i + 1], max_new=MAX_NEW, request_id=rid)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}


def _streams(evs, n):
    out = {r: [] for r in range(n)}
    for e in evs:
        if e.kind in ("token", "finished"):
            out[e.request_id].extend(e.tokens)
    return out


# --------------------------------------------------- against the JAX layer

def _overload(mod, slo_mod, params, cfg, pnp, prefix_cache):
    """Five batch requests on a pool of two residents, an interactive one
    after two rounds; the events and the summary."""
    sched = _sched(mod, params, cfg, kv_blocks=2 * NEED + 3 * prefix_cache,
                   **({"prefix_cache": True} if prefix_cache else {}))
    slo = slo_mod.SLOScheduler(sched, segment_steps=4)
    for b in range(5):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="batch",
                   request_id=b)
    evs = slo.step() + slo.step()
    slo.submit(pnp[5:6], max_new=MAX_NEW, slo_class="interactive",
               request_id=5)
    evs += slo.run_until_drained()
    return [(e.kind, e.request_id, [int(t) for t in e.tokens])
            for e in evs], slo.json_summary()


_STEP_FIELDS = ("preemptions", "replay_mismatches", "completed",
                "segment_steps", "total_steps")
_CLASS_FIELDS = ("priority", "completed", "preempted_times", "ttft_steps",
                 "itl_steps")


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_event_sequence_and_step_clocks_equal_the_jax_layer(prefix_cache):
    jcfg, jp, cfg, params = _pair()
    pnp = _prompts(cfg, 6)
    if prefix_cache:
        pnp[3] = pnp[0]           # a repeat the prefix cache serves
    jevs, js = _overload(jsched, jslo, jp, jcfg, pnp, prefix_cache)
    evs, s = _overload(sched_lib, slo_lib, params, cfg, pnp, prefix_cache)
    assert evs == jevs
    assert s["preemptions"] > 0
    for k in _STEP_FIELDS:
        assert s[k] == js[k], k
    assert s["classes"].keys() == js["classes"].keys()
    for name, c in s["classes"].items():
        for k in _CLASS_FIELDS:
            assert c[k] == js["classes"][name][k], (name, k)


# -------------------------------------------- the mechanism, in the port

def test_preempt_free_resubmit_regenerates_the_stream():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 2)
    ref = _reference(params, cfg, pnp, [0, 1])
    sched = _sched(sched_lib, params, cfg, kv_blocks=2 * NEED)
    for b in range(2):
        sched.submit(pnp[b:b + 1], max_new=MAX_NEW, request_id=b)
    sched.step(max_steps=6)          # past prefill (2 chunks), mid-decode
    assert sched._busy[:2].all()
    free_before = sched.free_blocks
    [p] = sched.preempt_slots([1])
    assert p.request_id == 1 and len(p.tokens) > 0
    np.testing.assert_array_equal(p.tokens, ref[1][:len(p.tokens)])
    assert sched.free_blocks == free_before + NEED
    assert sched.preemptions == 1
    assert int(sched.pool.cache["attn"].free_count) == sched.free_blocks
    sched.resubmit(p)
    got = {f.request_id: f.tokens for f in sched.run_until_drained()}
    for rid in (0, 1):
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert sched.free_blocks == sched.kv_blocks


def test_preempt_refuses_a_slot_not_resident():
    _, _, cfg, params = _pair()
    sched = _sched(sched_lib, params, cfg, kv_blocks=2 * NEED)
    with pytest.raises(ValueError, match="not resident"):
        sched.preempt_slots([0])


def test_preempt_mid_prefill_slot():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 1)
    ref = _reference(params, cfg, pnp, [0])
    sched = _sched(sched_lib, params, cfg, kv_blocks=NEED)
    sched.submit(pnp[0:1], max_new=MAX_NEW, request_id=0)
    sched.step(max_steps=1)          # 8 of 16 prompt positions written
    assert bool(sched.pool.prefilling[0])
    [p] = sched.preempt_slots([0])
    assert len(p.tokens) == 0 and sched.free_blocks == sched.kv_blocks
    sched.resubmit(p)
    got = {f.request_id: f.tokens for f in sched.run_until_drained()}
    np.testing.assert_array_equal(got[0], ref[0])


def test_reclaimable_counts_exclusive_blocks():
    _, _, cfg, params = _pair()
    sched = _sched(sched_lib, params, cfg, kv_blocks=2 * NEED)
    sched.submit(_prompts(cfg, 1)[0:1], max_new=MAX_NEW, request_id=0)
    sched.step(max_steps=2)
    reads = sched.host_reads
    rec = sched.reclaimable_host()      # the harvest's copy: no read
    assert sched.host_reads == reads
    assert rec[0] == NEED and rec[1:].sum() == 0
    np.testing.assert_array_equal(
        rec, sched.pool.cache["attn"].reclaimable().numpy())


# -------------------------------------------------- the policy, in the port

def test_overload_preempts_and_replays_bit_identical():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 6)
    ref = _reference(params, cfg, pnp, list(range(6)))
    sched = _sched(sched_lib, params, cfg, kv_blocks=2 * NEED)
    slo = slo_lib.SLOScheduler(sched, segment_steps=4)
    for b in range(5):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="batch",
                   request_id=b)
    evs = slo.step() + slo.step()
    slo.submit(pnp[5:6], max_new=MAX_NEW, slo_class="interactive",
               request_id=5)
    evs += slo.run_until_drained()
    streams = _streams(evs, 6)
    assert slo.preemptions > 0 and slo.replay_mismatches == 0
    assert slo.completed == 6
    for rid in range(6):
        np.testing.assert_array_equal(np.asarray(streams[rid]), ref[rid])
    assert sched.free_blocks == sched.kv_blocks
    s = slo.json_summary()
    assert s["classes"]["batch"]["preempted_times"] > 0
    assert s["classes"]["batch"]["completed"] == 5
    assert s["classes"]["interactive"]["completed"] == 1
    assert s["rounds"] == slo.rounds > 0


def test_priority_overtakes_a_backlog():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 7)
    sched = _sched(sched_lib, params, cfg, kv_blocks=2 * NEED)
    slo = slo_lib.SLOScheduler(sched, segment_steps=4)
    for b in range(6):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="batch",
                   request_id=b)
    slo.step()
    slo.submit(pnp[6:7], max_new=MAX_NEW, slo_class="interactive",
               request_id=6)
    slo.run_until_drained()
    s = slo.json_summary()["classes"]
    assert s["interactive"]["ttft_steps"]["p50"] < \
        s["batch"]["ttft_steps"]["p50"]


def test_equal_priority_never_preempts():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 4)
    slo = slo_lib.SLOScheduler(
        _sched(sched_lib, params, cfg, kv_blocks=2 * NEED), segment_steps=4)
    for b in range(4):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="interactive",
                   request_id=b)
    slo.run_until_drained()
    assert slo.preemptions == 0 and slo.completed == 4


def test_deadline_orders_within_a_class():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 2)
    slo = slo_lib.SLOScheduler(_sched(sched_lib, params, cfg,
                                      kv_blocks=NEED), segment_steps=4)
    slo.submit(pnp[0:1], max_new=MAX_NEW, slo_class="batch", deadline=100.0,
               request_id=0)
    slo.submit(pnp[1:2], max_new=MAX_NEW, slo_class="batch", deadline=50.0,
               request_id=1)
    order = []
    while slo.pending:
        order += [e.request_id for e in slo.step() if e.kind == "finished"]
    assert order == [1, 0]


def test_preemption_on_a_prefix_cached_pool():
    """READY registrations keep their pins (the replay maps them back),
    mid-prefill ones leave the index; the drained pool holds only the
    index's pins, on the host and on the device."""
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 4)
    ref = _reference(params, cfg, pnp, list(range(4)))
    sched = _sched(sched_lib, params, cfg, kv_blocks=3 * NEED,
                   prefix_cache=True)
    slo = slo_lib.SLOScheduler(sched, segment_steps=2)
    for b in range(3):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="batch",
                   request_id=b)
    evs = slo.step()
    slo.submit(pnp[3:4], max_new=MAX_NEW, slo_class="interactive",
               request_id=3)
    evs += slo.run_until_drained()
    streams = _streams(evs, 4)
    assert slo.preemptions > 0 and slo.replay_mismatches == 0
    for rid in range(4):
        np.testing.assert_array_equal(np.asarray(streams[rid]), ref[rid])
    idx = sched._prefix_index
    pinned = sum(1 for e in idx.entries.values() if e.block_id >= 0)
    assert sched.free_blocks == sched.kv_blocks - pinned
    assert int(sched.pool.cache["attn"].free_count) == sched.free_blocks
    assert all(e.ready for e in idx.entries.values())


def test_a_round_reads_the_host_as_the_scheduler_does():
    """The SLO layer adds no read of its own: its victim order
    (``reclaimable``) and the emissions it surfaces come from the
    harvest's read, so a round's reads are the inner segment's (here the
    host-read loop's flag reads and the harvest)."""
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 6)
    sched = _sched(sched_lib, params, cfg, kv_blocks=2 * NEED)
    slo = slo_lib.SLOScheduler(sched, segment_steps=4)
    for b in range(5):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="batch",
                   request_id=b)
    slo.step()
    slo.submit(pnp[5:6], max_new=MAX_NEW, slo_class="interactive",
               request_id=5)
    slo.run_until_drained()
    assert slo.preemptions > 0
    assert slo.host_reads == sched.host_reads == \
        sched.total_steps + 2 * sched.segments


def test_metrics_summary_shape():
    _, _, cfg, params = _pair()
    pnp = _prompts(cfg, 2)
    slo = slo_lib.SLOScheduler(_sched(sched_lib, params, cfg,
                                      kv_blocks=None), segment_steps=4)
    for b in range(2):
        slo.submit(pnp[b:b + 1], max_new=MAX_NEW, slo_class="interactive",
                   request_id=b)
    slo.run_until_drained()
    s = slo.json_summary()
    c = s["classes"]["interactive"]
    assert c["completed"] == 2
    for k in ("ttft_steps", "itl_steps", "ttft_wall_s", "itl_wall_s"):
        assert c[k]["p50"] is not None and c[k]["p99"] is not None
    assert c["ttft_attainment"] is not None
    assert s["replay_mismatches"] == 0 and s["total_steps"] > 0


def test_rejects_a_filled_inner_queue():
    _, _, cfg, params = _pair()
    sched = _sched(sched_lib, params, cfg, kv_blocks=None)
    sched.submit(_prompts(cfg, 1)[0:1], max_new=4)
    with pytest.raises(ValueError, match="ordering"):
        slo_lib.SLOScheduler(sched)
