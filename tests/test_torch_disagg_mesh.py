"""Disaggregation on disjoint submeshes: ``DisaggScheduler(prefill_mesh=,
decode_mesh=)`` on 8 gloo CPU ranks against the JAX package's colocated
scheduler and its disaggregated preemption.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs both
cases on the 4 + 4 split (``sharding.carve_slices(4)``: ranks 0-3 the
prefill slice, 4-7 the decode slice); each rank returns what the tests
below assert on. Weights: the JAX package's draws of smollm-135m (smoke)
at the reference test's key, fp32 compute.

- **4 + 4** (the JAX package's ``test_disagg_4plus4_submesh_split``): the
  slices are disjoint; each tier's scheduler exists only on its slice's
  ranks, and its pool's DTensors live on that slice's mesh (4 slots a
  tier: one slot and its blocks a rank); every request crosses the wire
  (``transfers == 6``, ``transfer_bytes > 0``, ``bcast:gloo-host``); the
  streams equal the JAX package's colocated chunked scheduler's token for
  token; both pools drain.
- **SLO preemption on the decode tier** (the reference's contention: two
  batch residents fill a decode tier of 2 slots and 14 blocks, then an
  urgent arrival): ``replay_mismatches == 0``, the preemptions and the
  streams equal the JAX package's single-process ``DisaggScheduler``'s.
  2 slots do not split over 4 ranks, so that decode tier is replicated
  on its slice (``pool_layout``).

JAX is imported in the parent process only.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import distributed

LENS = (3, 5, 9, 16, 1, 12)     # the reference test's prompt lengths
KW = dict(prompt_len=16, max_new_cap=6, eos_id=1, kv_block=4,
          chunk_tokens=5)


def _cfg():
    return dataclasses.replace(get_config("smollm-135m", smoke=True),
                               compute_dtype="float32")


def _tokens(fin):
    return {f.request_id: [int(t) for t in f.tokens] for f in fin}


def _contended(mod, params, cfg, prompts, **mesh):
    """The reference test's contention (``tests/test_torch_disagg.py``)."""
    d = mod.DisaggScheduler(
        params, cfg, n_prefill_slots=1, n_decode_slots=2, prompt_len=16,
        max_new_cap=16, eos_id=1, kv_block=4, chunk_tokens=5,
        decode_kv_blocks=14, segment_steps=2, prefill_segment_steps=4,
        **mesh)
    d.submit(prompts[0], max_new=8, request_id=0, priority=1)
    d.submit(prompts[1], max_new=8, request_id=1, priority=1)
    done = []
    for _ in range(3):
        done += d.step(max_steps=2)
    d.submit(prompts[2], max_new=4, request_id=2, priority=0)
    done += d.run_until_drained()
    return _tokens(done), d


def _ranks_case(np_params, prompts, contended):
    """Runs on every rank of the launch."""
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.serve import disagg as disagg_lib
    cfg = _cfg()
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    pf, de = sh.carve_slices(4)
    pf_mesh = sh.slice_mesh(pf, device_type="cpu")
    de_mesh = sh.slice_mesh(de, device_type="cpu")
    rank = dist.get_rank()
    d = disagg_lib.DisaggScheduler(params, cfg, n_prefill_slots=4,
                                   n_decode_slots=4, prefill_mesh=pf_mesh,
                                   decode_mesh=de_mesh, **KW)
    for b, p in enumerate(prompts):
        d.submit(p, max_new=6, request_id=b)
    got = _tokens(d.run_until_drained())
    tier = d.prefill if d.prefill is not None else d.decode
    k_pool = tier.sharded_pool.cache["attn"]["k_pool"]
    out = {"rank": rank, "slices": (pf, de), "role": d._role,
           "holds": (d.prefill is not None, d.decode is not None),
           "pool_ranks": sorted(int(r) for r in
                                k_pool.device_mesh.mesh.reshape(-1)),
           "placements": repr(tuple(k_pool.placements)),
           "layout": tier.pool_layout,
           "tokens": got, "transfers": d.transfers,
           "transfer_bytes": d.transfer_bytes,
           "transfer_impl": d.transfer_impl,
           "drained": (tier.free_blocks, tier.kv_blocks, d.pending)}
    ctoks, c = _contended(disagg_lib, params, cfg, contended,
                          prefill_mesh=pf_mesh, decode_mesh=de_mesh)
    ctier = c.prefill if c.prefill is not None else c.decode
    out["contended"] = {"tokens": ctoks, "preemptions": c.preemptions,
                        "replay_mismatches": c.replay_mismatches,
                        "layout": ctier.pool_layout,
                        "drained": (ctier.free_blocks, ctier.kv_blocks,
                                    c.pending)}
    return out


@pytest.fixture(scope="module")
def case():
    """The JAX package's results, then the 8-rank launch."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.serve import disagg as jdisagg
    from repro.serve import scheduler as jsched
    jcfg = dataclasses.replace(jax_get_config("smollm-135m", smoke=True),
                               compute_dtype="float32")
    key = jax.random.PRNGKey(3)
    jparams = jzoo.init_params(jcfg, key)
    prompts = [np.asarray(jax.random.randint(jax.random.fold_in(key, b),
                                             (1, L), 2, jcfg.vocab),
                          np.int32) for b, L in enumerate(LENS)]
    co = jsched.DecodeScheduler(jparams, jcfg, n_slots=2, kv="paged",
                                prefill="chunked", **KW)
    for b, p in enumerate(prompts):
        co.submit(p, max_new=6, request_id=b)
    ref = {f.request_id: [int(t) for t in f.tokens]
           for f in co.run_until_drained()}
    contended = [np.asarray(jax.random.randint(jax.random.fold_in(key, b),
                                               (1, 16), 2, jcfg.vocab),
                            np.int32) for b in range(3)]
    cref, jd = _contended(jdisagg, jparams, jcfg, contended)
    ranks = distributed.run_local(_ranks_case, 8,
                                  jax.tree.map(np.asarray, jparams),
                                  prompts, contended, timeout=300)
    return {"ref": ref, "cref": cref, "cpre": jd.preemptions,
            "ranks": ranks}


def test_disagg_4plus4_submesh_split(case):
    for r in case["ranks"]:
        pf, de = r["slices"]
        assert (pf, de) == ([0, 1, 2, 3], [4, 5, 6, 7])
        assert set(pf).isdisjoint(de)
        mine = pf if r["rank"] in pf else de
        assert r["role"] == ("prefill" if r["rank"] in pf else "decode")
        # each tier only on its slice's ranks, split one slot a rank
        assert r["holds"] == (r["rank"] in pf, r["rank"] in de)
        assert r["pool_ranks"] == mine
        assert r["placements"] == "(Shard(dim=1),)"
        assert r["layout"] == "sharded:datax4"
        assert r["transfers"] == len(LENS) and r["transfer_bytes"] > 0
        assert r["transfer_impl"] == "bcast:gloo-host"
        assert r["tokens"] == case["ref"]
        free, total, pending = r["drained"]
        assert free == total and pending == 0


def test_slo_preemption_on_the_decode_tier(case):
    for r in case["ranks"]:
        c = r["contended"]
        assert c["preemptions"] == case["cpre"] >= 1
        assert c["replay_mismatches"] == 0
        assert c["tokens"] == case["cref"]
        assert c["layout"] == "replicated"
        free, total, pending = c["drained"]
        assert free == total and pending == 0
