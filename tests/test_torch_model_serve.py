"""Serving on a model axis: ``DecodeScheduler(rules=, mesh=)`` on the
(4, 2) data x model mesh of 8 gloo CPU ranks, each rank on its slices of
the weights and its K/V heads, against the JAX package.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
case; the JAX package's results are made in the same module fixture.
The configs are smoke width in fp32 compute, the weights the JAX
package's draws given to the ranks as numpy arrays
(``bridge.from_numpy``):

- **llama3.2-1b** (8/2 heads, d_ff 128, padded vocab 512): ``HEADS``,
  ``KV_HEADS``, ``MLP`` and ``VOCAB`` all bind to ``model``. Dense and
  paged one-shot pools (the paged one through the kernels' plain
  versions, ``attn_impl="cuda"``) against ``generate_batch_sync``;
  chunked paged pools with the prefix cache and with n-gram speculation
  against the JAX scheduler with the prefix cache (the hit count too).
  Every rank's K/V pool holds KV/2 heads, its DTensor view is split over
  ``model`` there, ``COUNTS["whole_gathers"] == 0``, and a rank's
  parameter bytes are the whole model's over 2 plus the replicated
  norms.
- **qwen2-moe-a2.7b** (6 experts): ``EXPERT`` binds, so each rank holds 3
  experts' rows. A rank-one router sends every token to one of two
  expert pairs, so the decode's one group of 12 slots overflows its
  capacity: one-shot and chunked streams equal the JAX scheduler's, and
  the capacity and drops of every routing equal the one-rank port's. A
  rank's parameter bytes are the whole over 2 plus the norms and the
  router.

Tokens are compared exactly (greedy, fp32). JAX is imported in the parent
process only: the ranks import this module to find their function and
start without it.
"""

import dataclasses

import numpy as np
import pytest
import torch.utils._pytree as pytree

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import distributed

MESH = (4, 2)
N_SLOTS, PROMPT_LEN, SHARED_LEN, MAX_NEW = 4, 8, 16, 6
MOE_SLOTS, MOE_LEN, MOE_NEW = 12, 6, 8


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32")


def _tokens(fin):
    return {f.request_id: [int(t) for t in f.tokens] for f in fin}


def _serve(sched, reqs):
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return _tokens(sched.run_until_drained())


def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def _param_split(params, local, cfg, rules):
    """(bytes a rank holds, the whole model's bytes of the leaves the
    rules split over ``model``, of those they leave whole, and the names
    of the latter)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    axes = {pytree.keystr(k): a for k, a in pytree.tree_flatten_with_path(
        model_zoo.param_axes(cfg),
        is_leaf=lambda a: isinstance(a, tuple))[0]}
    split, kept, names = 0, 0, []
    for path, t in pytree.tree_flatten_with_path(params)[0]:
        n = t.numel() * t.element_size()
        ax = axes[pytree.keystr(path)]
        if sh._model_dim(rules, ax, tuple(t.shape)) is None:
            kept += n
            names.append(pytree.keystr(path))
        else:
            split += n
    return _bytes(local), split, kept, names


def _kv(sched):
    """(K/V heads of the rank's pool, placements of its DTensor view)."""
    node = sched.pool.cache["attn"]
    k = node.k_pool if hasattr(node, "k_pool") else node.k
    view = sched.sharded_pool.cache["attn"]
    view = view["k_pool"] if "k_pool" in view else view["k"]
    return int(k.shape[3]), tuple(repr(p) for p in view.placements)


def _llama(mesh, np_params, prompts, shared):
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_lib
    from repro_torch.serve import speculative as spec_lib
    cfg = _cfg("llama3.2-1b")
    kcfg = dataclasses.replace(cfg, attn_impl="cuda")
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    chunked = dict(kv="paged", kv_block=4, prefill="chunked",
                   chunk_tokens=5, prompt_len=SHARED_LEN)
    runs = {"dense-oneshot": (cfg, prompts, dict(kv="dense")),
            "paged-oneshot": (kcfg, prompts, dict(kv="paged", kv_block=4)),
            "prefix": (kcfg, shared, dict(chunked, prefix_cache=True)),
            "ngram": (kcfg, shared, dict(chunked,
                                         speculative=spec_lib.SpecConfig(
                                             k=2, drafter="ngram",
                                             ngram=2))),
            # the target drafting for itself: the draft's weights and its
            # dense cache follow the same rules
            "model-drafter": (kcfg, shared, dict(
                chunked, speculative=spec_lib.SpecConfig(k=2,
                                                         drafter="model"),
                draft_params=params, draft_cfg=kcfg))}
    out = {}
    for name, (c, reqs, kw) in runs.items():
        kw = {"prompt_len": PROMPT_LEN, **kw}
        sh.reset_counts()
        s = sched_lib.DecodeScheduler(params, c, n_slots=N_SLOTS,
                                      max_new_cap=MAX_NEW, eos_id=1,
                                      rules=rules, mesh=mesh, **kw)
        out[name] = dict(tokens=_serve(s, reqs), layout=s.model_layout,
                         kv=_kv(s), attn=s.attn_impl,
                         hits=s.prefix_hit_blocks,
                         drafted=s.drafted_tokens,
                         counts=dict(sh.COUNTS),
                         draft_kv=(int(s.pool.draft["attn"].k.shape[3])
                                   if s.pool.draft else None))
    out["bytes"] = _param_split(params, s.params, cfg, rules)
    out["offsets"] = {k: s._split.offsets[k] for k in ("embed",)}
    out["offsets"]["wq"] = s._split.offsets["layers"]["attn"]["wq"]
    return out


def _moe(mesh, np_params, reqs):
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo, moe
    from repro_torch.serve import scheduler as sched_lib
    cfg = _cfg("qwen2-moe-a2.7b")
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    route, seen = moe.route, []

    def recorded(expert_idx, E, C):
        maps = route(expert_idx, E, C)
        seen.append((tuple(expert_idx.shape), C, int(maps[3].sum())))
        return maps

    moe.route = recorded
    out = {}
    try:
        for prefill in ("oneshot", "chunked"):
            for where in ("mesh", "one"):
                seen.clear()
                sh.reset_counts()
                s = sched_lib.DecodeScheduler(
                    params, cfg, n_slots=MOE_SLOTS, prompt_len=MOE_LEN,
                    max_new_cap=MOE_NEW, eos_id=1, kv="paged", kv_block=4,
                    prefill=prefill, chunk_tokens=3,
                    **(dict(rules=rules, mesh=mesh) if where == "mesh"
                       else {}))
                out[(prefill, where)] = dict(
                    tokens=_serve(s, reqs), routes=list(seen),
                    layout=s.model_layout, kv=_kv(s) if where == "mesh"
                    else None, counts=dict(sh.COUNTS),
                    w_gate=tuple(s.params["layers"]["moe"]["w_gate"].shape))
                if where == "mesh":
                    held = s.params
    finally:
        moe.route = route
    out["bytes"] = _param_split(params, held, cfg, rules)
    return out


def _ranks_case(np_llama, np_moe, prompts, shared, moe_reqs):
    """Runs on every rank of the launch."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(MESH, ("data", "model"), "cpu")
    return {"rank": dist.get_rank(),
            "llama": _llama(mesh, np_llama, prompts, shared),
            "moe": _moe(mesh, np_moe, moe_reqs)}


def _skewed_router(jp, seed=3):
    """A rank-one router: every token's top two experts are one of two
    pairs, so a decode group of 12 tokens overflows its capacity of 8."""
    rng = np.random.default_rng(seed)
    L, D, E = jp["layers"]["moe"]["router"].shape
    jp["layers"]["moe"]["router"] = (
        rng.standard_normal((L, D, 1)).astype(np.float32)
        * np.linspace(3, -3, E).astype(np.float32)[None, None])
    return jp


@pytest.fixture(scope="module")
def case():
    """The JAX package's results, then the 8-rank launch."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.serve import engine as jengine
    from repro.serve import scheduler as jsched

    def jcfg_of(arch):
        return dataclasses.replace(jax_get_config(arch, smoke=True),
                                   compute_dtype="float32")

    def jstreams(jp, jcfg, reqs, **kw):
        s = jsched.DecodeScheduler(jp, jcfg, **kw)
        for rid, (p, m) in enumerate(reqs):
            s.submit(p, max_new=m, request_id=rid)
        return _tokens(s.run_until_drained()), s

    init = jax.jit(jzoo.init_params, static_argnums=0)
    jcfg = jcfg_of("llama3.2-1b")
    jp = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))
    block = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (6, 8), 2,
                                          jcfg.vocab), np.int32)
    prompts = [(block[b:b + 1], MAX_NEW) for b in range(6)]
    sync = jengine.generate_batch_sync(jp, jcfg, block, max_new=MAX_NEW,
                                       eos_id=1)
    rng = np.random.default_rng(5)
    head = rng.integers(2, jcfg.vocab, (1, 12)).astype(np.int32)
    shared = [(np.concatenate([head, rng.integers(2, jcfg.vocab, (1, 4))
                               .astype(np.int32)], axis=1), MAX_NEW)
              for _ in range(6)]
    jprefix, js = jstreams(jp, jcfg, shared, n_slots=N_SLOTS,
                           prompt_len=SHARED_LEN, max_new_cap=MAX_NEW,
                           eos_id=1, kv="paged", kv_block=4,
                           prefill="chunked", chunk_tokens=5,
                           prefix_cache=True)
    mcfg = jcfg_of("qwen2-moe-a2.7b")
    mp = _skewed_router(jax.tree.map(
        np.copy, jax.tree.map(np.asarray,
                              init(mcfg, jax.random.PRNGKey(2)))))
    rng = np.random.default_rng(3)
    moe_reqs = [(rng.integers(2, mcfg.vocab, (1, MOE_LEN)).astype(np.int32),
                 int(rng.integers(2, MOE_NEW + 1))) for _ in range(14)]
    jmoe = {prefill: jstreams(mp, mcfg, moe_reqs, n_slots=MOE_SLOTS,
                              prompt_len=MOE_LEN, max_new_cap=MOE_NEW,
                              eos_id=1, kv="paged", kv_block=4,
                              prefill=prefill, chunk_tokens=3)[0]
            for prefill in ("oneshot", "chunked")}
    ranks = distributed.run_local(_ranks_case, 8, jp, mp, prompts, shared,
                                  moe_reqs, timeout=300)
    return {"sync": np.asarray(sync.tokens), "jprefix": jprefix,
            "jprefix_hits": js.prefix_hit_blocks, "jmoe": jmoe,
            "ranks": ranks}


def test_dense_streams_equal_jax_on_a_model_axis(case):
    for r in case["ranks"]:
        got = r["llama"]
        for name in ("dense-oneshot", "paged-oneshot"):
            toks = got[name]["tokens"]
            assert sorted(toks) == list(range(6))
            for rid, t in toks.items():
                np.testing.assert_array_equal(
                    t, case["sync"][rid, :len(t)], err_msg=name)
        assert got["paged-oneshot"]["attn"] == "torch-plain-paged:cpu"
        assert got["prefix"]["tokens"] == case["jprefix"]
        assert got["prefix"]["hits"] == case["jprefix_hits"] > 0
        for name in ("ngram", "model-drafter"):
            assert got[name]["tokens"] == case["jprefix"], name
            assert got[name]["drafted"] > 0
        assert got["model-drafter"]["draft_kv"] == \
            _cfg("llama3.2-1b").n_kv_heads // 2


def test_each_rank_holds_its_slices_and_kv_heads(case):
    """KV/2 heads a rank in the pool (its DTensor view split over
    ``model`` on the head dim), no weight whole, the layout named, and
    the parameter bytes halved but for the replicated norms."""
    kv = _cfg("llama3.2-1b").n_kv_heads
    for r in case["ranks"]:
        for name, got in r["llama"].items():
            if name in ("bytes", "offsets"):
                continue
            assert got["layout"] == "split:modelx2"
            assert got["counts"]["whole_gathers"] == 0
            assert got["counts"]["split_all_reduces"] > 0
            assert got["counts"]["vocab_gathers"] > 0
            heads, placements = got["kv"]
            assert heads == kv // 2
            assert placements == ("Shard(dim=1)", "Shard(dim=3)")
        held, split, kept, names = r["llama"]["bytes"]
        assert held == split // 2 + kept
        assert names and all("ln_" in n for n in names), names
        # where each slice starts: the model coordinate is rank % 2
        cfg = _cfg("llama3.2-1b")
        m = r["rank"] % MESH[1]
        assert r["llama"]["offsets"] == {
            "embed": (m * cfg.padded_vocab // 2, 0),
            "wq": (0, 0, m * cfg.n_heads // 2, 0)}


def test_moe_streams_and_drops_on_a_model_axis(case):
    """Every rank holds 3 of the 6 experts; its streams equal the JAX
    scheduler's, and each routing (capacity and drops) the one-rank
    port's, with drops in the decode's group."""
    cfg = _cfg("qwen2-moe-a2.7b")
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    for r in case["ranks"]:
        got = r["moe"]
        for prefill in ("oneshot", "chunked"):
            mesh, one = got[(prefill, "mesh")], got[(prefill, "one")]
            assert mesh["tokens"] == case["jmoe"][prefill]
            assert mesh["tokens"] == one["tokens"]
            assert mesh["routes"] == one["routes"]
            assert sum(d for shape, _, d in mesh["routes"]
                       if shape[:2] == (1, MOE_SLOTS)) > 0
            assert mesh["layout"] == "split:modelx2"
            assert one["layout"] == "single"
            assert mesh["counts"]["whole_gathers"] == 0
            assert mesh["w_gate"] == (cfg.n_layers, E // 2, D, F)
            assert mesh["kv"][0] == cfg.n_kv_heads // 2
        held, split, kept, names = got["bytes"]
        assert held == split // 2 + kept
        assert names and all("ln_" in n or "router" in n
                             for n in names), names
