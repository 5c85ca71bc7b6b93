"""Serving on a mesh: ``DecodeScheduler(rules=, mesh=)`` on gloo CPU ranks
against the JAX package's scheduler and engine.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
case; each rank returns what the tests below assert on. Ranks 0-3 and
4-7 each form a (4,) data mesh (``sharding.slice_mesh``), and the
cases run on both halves at once; the last case runs on the (4, 2) data
x model mesh of all 8 ranks. The weights are the JAX package's draws of
smollm-135m (smoke) in fp32 compute, given to the ranks as numpy arrays
(``bridge.from_numpy``).

- **Sharded slot pool** (the JAX package's ``test_sharded_slot_pool_8dev``):
  dense and paged one-shot pools of 4 slots on a (4,) data mesh; every
  slot register and cache leaf of ``sharded_pool`` is a DTensor with
  ``Shard`` on the slot or block dim over ``data``; the greedy tokens of
  6 requests equal the JAX package's ``engine.generate_batch_sync``
  tokens exactly; ``free_blocks == kv_blocks`` after draining.
- **Prefix cache** (chunked, paged): requests sharing a 12-token prefix;
  tokens equal the JAX scheduler's, the hit count equals its, and the
  hits on another shard's blocks are copied in
  (``cross_rank_block_copies > 0``).
- **SLO preemption**: an interactive arrival preempts a batch resident of
  a full sharded pool; ``replay_mismatches == 0`` and the streams equal
  the mesh-less port's.
- **n-gram speculation** on the (4, 2) data x model mesh (the pool split
  over data, replicated over model): tokens equal the JAX scheduler's
  non-speculative ones, and every rank reports the host-read lowering.

Tokens are compared exactly (greedy, fp32), as the reference test does.
JAX is imported in the parent process only: the ranks import this
module to find their function and start without it.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import distributed

N_SLOTS, PROMPT_LEN, MAX_NEW = 4, 8, 6


def _cfg():
    return dataclasses.replace(get_config("smollm-135m", smoke=True),
                               compute_dtype="float32")


def _tokens(fin):
    return {f.request_id: [int(t) for t in f.tokens] for f in fin}


def _serve(sched, prompts, **kw):
    for b, p in enumerate(prompts):
        sched.submit(p, max_new=MAX_NEW, request_id=b, **kw)
    return _tokens(sched.run_until_drained())


def _placements(pool):
    """(field, placements) of every DTensor leaf of a placed pool."""
    from repro_torch.dist import sharding as sh
    out = []
    for name in ("next_token", "cur_len", "active", "out", "keys"):
        out.append((name, getattr(pool, name)))
    for key, node in pool.cache.items():
        for leaf, t in node.items():
            out.append((f"cache.{key}.{leaf}", t))
    return [(n, sh.is_dtensor(t), tuple(repr(p) for p in t.placements)
             if sh.is_dtensor(t) else None) for n, t in out]


def _slo_case(sched_lib, slo_lib, params, cfg, prompts, mesh=None,
              rules=None):
    inner = sched_lib.DecodeScheduler(
        params, cfg, n_slots=N_SLOTS, prompt_len=PROMPT_LEN,
        max_new_cap=16, eos_id=-1, kv="paged", kv_block=4,
        prefill="chunked", chunk_tokens=5, rules=rules, mesh=mesh)
    slo = slo_lib.SLOScheduler(inner, segment_steps=2)
    for b in range(N_SLOTS):
        slo.submit(prompts[b], max_new=16, slo_class="batch",
                   request_id=b, deadline=float(b))
    events = slo.step() + slo.step()
    slo.submit(prompts[4], max_new=4, slo_class="interactive",
               request_id=4, deadline=0.0)
    events += slo.run_until_drained()
    streams = {}
    for e in events:
        streams.setdefault(e.request_id, []).extend(int(t)
                                                    for t in e.tokens)
    return {"streams": streams, "preemptions": slo.preemptions,
            "replay_mismatches": slo.replay_mismatches}


def _ranks_case(np_params, prompts, shared):
    """Runs on every rank of the launch."""
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_lib
    from repro_torch.serve import slo as slo_lib
    from repro_torch.serve import speculative as spec_lib
    cfg = _cfg()
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    rank = dist.get_rank()
    halves = [sh.slice_mesh(range(0, 4), device_type="cpu"),
              sh.slice_mesh(range(4, 8), device_type="cpu")]
    mesh = halves[rank // 4]
    rules = model_zoo.make_rules(cfg, mesh)
    out = {"rank": rank}
    # the sharded slot pool, dense and paged (the reference test)
    for kv in ("dense", "paged"):
        s = sched_lib.DecodeScheduler(
            params, cfg, n_slots=N_SLOTS, prompt_len=PROMPT_LEN,
            max_new_cap=MAX_NEW, eos_id=1, kv=kv, kv_block=4, rules=rules,
            mesh=mesh)
        placed = _placements(s.sharded_pool)
        out[kv] = {"tokens": _serve(s, prompts), "placed": placed,
                   "layout": s.pool_layout, "loop": s.loop_impl,
                   "free": s.free_blocks, "kv_blocks": s.kv_blocks,
                   "local_slots": int(s.pool.next_token.shape[0])}
    # the prefix cache (chunked, paged), requests sharing a prefix
    s = sched_lib.DecodeScheduler(
        params, cfg, n_slots=N_SLOTS, prompt_len=16, max_new_cap=MAX_NEW,
        eos_id=1, kv="paged", kv_block=4, prefill="chunked",
        chunk_tokens=5, prefix_cache=True, rules=rules, mesh=mesh)
    out["prefix"] = {"tokens": _serve(s, shared),
                     "hits": s.prefix_hit_blocks,
                     "copies": s.cross_rank_block_copies,
                     "layout": s.pool_layout}
    # SLO preemption on the mesh and off it
    out["slo"] = _slo_case(sched_lib, slo_lib, params, cfg, prompts, mesh,
                           rules)
    out["slo_off"] = _slo_case(sched_lib, slo_lib, params, cfg, prompts)
    # n-gram speculation on the (4, 2) data x model mesh of all ranks
    full = mesh_lib.make_mesh((4, 2), ("data", "model"), "cpu")
    s = sched_lib.DecodeScheduler(
        params, cfg, n_slots=N_SLOTS, prompt_len=PROMPT_LEN,
        max_new_cap=MAX_NEW, eos_id=1, kv="paged", kv_block=4,
        prefill="chunked", chunk_tokens=5,
        speculative=spec_lib.SpecConfig(k=2, drafter="ngram", ngram=2),
        rules=model_zoo.make_rules(cfg, full), mesh=full)
    out["spec"] = {"tokens": _serve(s, prompts), "layout": s.pool_layout,
                   "drafted": s.drafted_tokens, "loop": s.loop_impl}
    return out


@pytest.fixture(scope="module")
def case():
    """The JAX package's results, then the 8-rank launch."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.serve import engine as jengine
    from repro.serve import scheduler as jsched
    jcfg = dataclasses.replace(jax_get_config("smollm-135m", smoke=True),
                               compute_dtype="float32")
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    block = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (6, 8), 2,
                                          jcfg.vocab), np.int32)
    prompts = [block[b:b + 1] for b in range(6)]
    sync = jengine.generate_batch_sync(jparams, jcfg, block,
                                       max_new=MAX_NEW, eos_id=1)
    rng = np.random.default_rng(5)
    head = rng.integers(2, jcfg.vocab, (1, 12)).astype(np.int32)
    shared = [np.concatenate([head, rng.integers(2, jcfg.vocab, (1, 4))
                              .astype(np.int32)], axis=1)
              for _ in range(6)]
    j = jsched.DecodeScheduler(jparams, jcfg, n_slots=N_SLOTS,
                               prompt_len=16, max_new_cap=MAX_NEW, eos_id=1,
                               kv="paged", kv_block=4, prefill="chunked",
                               chunk_tokens=5, prefix_cache=True)
    for b, p in enumerate(shared):
        j.submit(p, max_new=MAX_NEW, request_id=b)
    jprefix = {f.request_id: [int(t) for t in f.tokens]
               for f in j.run_until_drained()}
    j2 = jsched.DecodeScheduler(jparams, jcfg, n_slots=N_SLOTS,
                                prompt_len=PROMPT_LEN, max_new_cap=MAX_NEW,
                                eos_id=1, kv="paged", kv_block=4,
                                prefill="chunked", chunk_tokens=5)
    for b, p in enumerate(prompts):
        j2.submit(p, max_new=MAX_NEW, request_id=b)
    jchunk = {f.request_id: [int(t) for t in f.tokens]
              for f in j2.run_until_drained()}
    ranks = distributed.run_local(_ranks_case, 8, np_params, prompts,
                                  shared, timeout=300)
    return {"sync": np.asarray(sync.tokens), "jprefix": jprefix,
            "jprefix_hits": j.prefix_hit_blocks, "jchunk": jchunk,
            "ranks": ranks}


def test_sharded_slot_pool_8dev(case):
    for r in case["ranks"]:
        for kv in ("dense", "paged"):
            got = r[kv]
            assert got["layout"] == "sharded:datax4"
            assert got["loop"] == "host-read"
            assert got["local_slots"] == 1       # 4 slots over 4 ranks
            lead = 1                             # the slot or block dim
            for name, is_dt, placements in got["placed"]:
                assert is_dt, name
                dim = lead if name.startswith("cache.attn.k") \
                    or name.startswith("cache.attn.v") else 0
                assert placements == (f"Shard(dim={dim})",), \
                    (name, placements)
            assert sorted(got["tokens"]) == list(range(6))
            for rid, toks in got["tokens"].items():
                np.testing.assert_array_equal(
                    toks, case["sync"][rid, :len(toks)])
            if kv == "paged":
                assert got["free"] == got["kv_blocks"]


def test_prefix_cache_on_a_sharded_pool(case):
    for r in case["ranks"]:
        got = r["prefix"]
        assert got["tokens"] == case["jprefix"]
        assert got["hits"] == case["jprefix_hits"] > 0
        assert got["copies"] > 0          # a hit in another shard's blocks
    # every rank of a mesh counts the same
    assert len({r["prefix"]["copies"] for r in case["ranks"]}) == 1


def test_slo_preemption_on_a_sharded_pool(case):
    for r in case["ranks"]:
        got, off = r["slo"], r["slo_off"]
        assert got["preemptions"] >= 1
        assert got["replay_mismatches"] == 0
        assert got["preemptions"] == off["preemptions"]
        assert got["streams"] == off["streams"]


def test_speculation_on_a_data_model_mesh(case):
    for r in case["ranks"]:
        got = r["spec"]
        assert got["layout"] == "sharded:datax4"
        assert got["loop"] == "host-read" and got["drafted"] > 0
        assert got["tokens"] == case["jchunk"]


def test_a_graph_segment_is_refused_on_a_mesh():
    """The host-read lowering is the only one on a mesh larger than one
    device: asking for the graph raises, before any group is touched."""
    from repro_torch.dist import sharding as sh
    from repro_torch.serve import scheduler as sched_lib

    class _Mesh:                          # a two-device mesh's interface
        mesh_dim_names = ("data",)
        shape = (2,)

        def size(self, dim=None):
            return 2

    cfg = _cfg()
    params = bridge.init_params(cfg, seed=0, device="cpu")
    rules = sh.resolve_rules({"data": 2})
    with pytest.raises(ValueError, match="host-read segment"):
        sched_lib.DecodeScheduler(params, cfg, n_slots=2, prompt_len=8,
                                  max_new_cap=4, loop="graph", rules=rules,
                                  mesh=_Mesh())
