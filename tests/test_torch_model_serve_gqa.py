"""Serving on a model axis that splits the query heads and not the K/V
heads: ``DecodeScheduler(rules=, mesh=)`` on the (2, 4) data x model mesh
of 8 gloo CPU ranks against the JAX package, and the head range that the
attention kernels take there.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
rank case; the JAX package's results are made in the same module
fixture. The configs are smoke width in fp32 compute, the weights the
JAX package's draws given to the ranks as numpy arrays
(``bridge.from_numpy``):

- **internvl2-1b** (4/2 heads): ``HEADS`` binds to ``model`` and
  ``KV_HEADS`` does not, so each rank holds one query head, ``q_head0 =
  rank``, against both K/V heads, and its cache keeps both
  (``CACHE_KV`` replicated, as in the JAX layout). A one-shot dense pool
  (the gather path) against ``generate_batch_sync``, and chunked paged
  pools through the kernels' plain versions (``attn_impl="cuda"``),
  plain and with n-gram speculation (``flash_verify``), against the JAX
  scheduler, every request with its patches. With early exit, the
  streams and every request's depth equal the one-rank port's at a
  threshold that splits the exits.
- **qwen2-moe-a2.7b** (6 experts, which 4 does not divide): ``EXPERT_MLP``
  binds, so each rank holds 12 of every expert's 48 hidden columns; a
  chunked paged pool against the JAX scheduler.

Rank-free: the plain ``paged_attention``, ``flash_prefill`` and
``flash_verify``, and the gather paths of ``models.attention``, at every
``q_head0`` of internvl2-1b's full 14/2 heads split 7 ways (ranges that
straddle the two K/V heads) against the whole call's heads (fp32, 2e-5);
the vocab-parallel lookup and the logits' gather over simulated ranks
against the whole table, exactly.

Tokens are compared exactly (greedy, fp32). JAX is imported in the parent
process only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import distributed
from repro_torch.models import attention
from repro_torch.serve import kv_cache as kvc

MESH = (2, 4)
N_SLOTS, PROMPT_LEN, MAX_NEW, N_REQ = 4, 8, 6, 4
TOL = 2e-5


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32", **kw)


def _tokens(fin):
    return {f.request_id: [int(t) for t in f.tokens] for f in fin}


def _serve(sched, reqs):
    for rid, (p, pe) in enumerate(reqs):
        sched.submit(p, max_new=MAX_NEW, request_id=rid,
                     **({} if pe is None else {"prefix_embeds": pe}))
    fin = sched.run_until_drained()
    return _tokens(fin), {f.request_id: f.mean_depth for f in fin}


def _vlm(mesh, np_params, reqs):
    from repro_torch.dist import sharding as sh
    from repro_torch.models import adaptive, model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve import scheduler as sched_lib
    from repro_torch.serve import speculative as spec_lib
    cfg = _cfg("internvl2-1b")
    kcfg = dataclasses.replace(cfg, attn_impl="cuda")
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    vlm = dict(n_slots=N_SLOTS, prompt_len=PROMPT_LEN, max_new_cap=MAX_NEW,
               eos_id=1, prefix_len=cfg.n_patches)
    chunked = dict(vlm, kv="paged", kv_block=4, prefill="chunked",
                   chunk_tokens=5)

    def run(c, where="mesh", **kw):
        sh.reset_counts()
        s = sched_lib.DecodeScheduler(
            params, c, **kw, **(dict(rules=rules, mesh=mesh)
                                if where == "mesh" else {}))
        toks, depth = _serve(s, reqs)
        k = s.pool.cache["attn"]
        return dict(tokens=toks, depth=depth, layout=s.model_layout,
                    attn=s.attn_impl, counts=dict(sh.COUNTS),
                    kv=int((k.k_pool if hasattr(k, "k_pool") else k.k)
                           .shape[3]),
                    wq=tuple(s.params["layers"]["attn"]["wq"].shape))

    out = {"oneshot": run(cfg, **vlm, kv="dense"),
           "chunked": run(kcfg, **chunked),
           "ngram": run(kcfg, **chunked, speculative=spec_lib.SpecConfig(
               k=2, drafter="ngram", ngram=2))}
    # early exit: a threshold in the widest gap between the margins of a
    # one-rank run that never exits, so that some rows exit and others
    # not. The decisions compared are each decode's depth for the rows
    # that emit and go on: a row's last decode runs after its blocks were
    # freed (as in the JAX package), so what it reads there depends on
    # which blocks its shard holds
    margin, decode, seen, taken = adaptive.exit_margin, engine.decode_step, \
        [], {}
    at = {}

    def recorded(*a, **kw):
        m = margin(*a, **kw)
        seen.append(m.clone())
        return m

    def decisions(*a, **kw):
        logits, depth = decode(*a, **kw)
        p = at["sched"].pool
        go = kw["live"] & (p.n_emitted < p.budget)
        for rid, n, d in zip(p.request_id[go].tolist(),
                             p.n_emitted[go].tolist(), depth[go].tolist()):
            taken[(rid, n)] = d
        return logits, depth

    adaptive.exit_margin, engine.decode_step = recorded, decisions
    try:
        at["sched"] = sched_lib.DecodeScheduler(
            params, dataclasses.replace(kcfg, early_exit=True), **chunked)
        _serve(at["sched"], reqs)
        s = torch.cat(seen).sort().values
        lo, hi = len(s) // 4, 3 * len(s) // 4
        k = lo + int(torch.argmax(s[lo + 1:hi + 1] - s[lo:hi]))
        thr = float(s[k] + s[k + 1]) / 2
        acfg = dataclasses.replace(kcfg, early_exit=True,
                                   exit_threshold=thr, exit_min_layers=1)
        out["exit"] = {}
        for where in ("mesh", "one"):
            taken.clear()
            at["sched"] = sched_lib.DecodeScheduler(
                params, acfg, **chunked, **(dict(rules=rules, mesh=mesh)
                                            if where == "mesh" else {}))
            toks, _ = _serve(at["sched"], reqs)
            out["exit"][where] = dict(tokens=toks, depths=dict(taken),
                                      layout=at["sched"].model_layout)
        out["exit_gap"] = float(s[k + 1] - s[k])
    finally:
        adaptive.exit_margin, engine.decode_step = margin, decode
    return out


def _moe(mesh, np_params, reqs):
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_lib
    cfg = _cfg("qwen2-moe-a2.7b")
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    sh.reset_counts()
    s = sched_lib.DecodeScheduler(
        params, cfg, n_slots=N_SLOTS, prompt_len=PROMPT_LEN,
        max_new_cap=MAX_NEW, eos_id=1, kv="paged", kv_block=4,
        prefill="chunked", chunk_tokens=5, rules=rules, mesh=mesh)
    toks, _ = _serve(s, reqs)
    return dict(tokens=toks, layout=s.model_layout, counts=dict(sh.COUNTS),
                routes={a: rules.mesh_axes(a) for a in (sh.EXPERT,
                                                        sh.EXPERT_MLP)},
                w_gate=tuple(s.params["layers"]["moe"]["w_gate"].shape))


def _ranks_case(np_vlm, np_moe, vlm_reqs, moe_reqs):
    """Runs on every rank of the launch."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(MESH, ("data", "model"), "cpu")
    return {"rank": dist.get_rank(),
            "vlm": _vlm(mesh, np_vlm, vlm_reqs),
            "moe": _moe(mesh, np_moe, moe_reqs)}


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
        s = jsched.DecodeScheduler(jp, jcfg, n_slots=N_SLOTS,
                                   prompt_len=PROMPT_LEN,
                                   max_new_cap=MAX_NEW, eos_id=1,
                                   kv="paged", kv_block=4,
                                   prefill="chunked", chunk_tokens=5, **kw)
        for rid, (p, pe) in enumerate(reqs):
            s.submit(p, max_new=MAX_NEW, request_id=rid,
                     **({} if pe is None else {"prefix_embeds": pe}))
        return _tokens(s.run_until_drained())

    init = jax.jit(jzoo.init_params, static_argnums=0)
    vcfg = jcfg_of("internvl2-1b")
    vp = jax.tree.map(np.asarray, init(vcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(6)
    prompt = rng.integers(2, vcfg.vocab, (N_REQ, 7)).astype(np.int32)
    pe = rng.standard_normal((N_REQ, vcfg.n_patches,
                              vcfg.d_model)).astype(np.float32)
    vlm_reqs = [(prompt[i:i + 1], pe[i:i + 1]) for i in range(N_REQ)]
    sync = jengine.generate_batch_sync(vp, vcfg, prompt, max_new=MAX_NEW,
                                       eos_id=1, prefix_embeds=pe)
    jvlm = jstreams(vp, vcfg, vlm_reqs, prefix_len=vcfg.n_patches)
    mcfg = jcfg_of("qwen2-moe-a2.7b")
    mp = jax.tree.map(np.asarray, init(mcfg, jax.random.PRNGKey(3)))
    moe_reqs = [(rng.integers(2, mcfg.vocab, (1, PROMPT_LEN))
                 .astype(np.int32), None) for _ in range(6)]
    jmoe = jstreams(mp, mcfg, moe_reqs)
    ranks = distributed.run_local(_ranks_case, 8, vp, mp, vlm_reqs,
                                  moe_reqs, timeout=300)
    return {"sync": np.asarray(sync.tokens), "jvlm": jvlm, "jmoe": jmoe,
            "ranks": ranks}


def test_gqa_head_range_streams_equal_jax(case):
    """One query head a rank against both K/V heads: the gather path and
    the kernels' plain versions (chunk, decode, verify) give the JAX
    package's tokens, with no weight whole."""
    cfg = _cfg("internvl2-1b")
    for r in case["ranks"]:
        got = r["vlm"]
        for rid, t in got["oneshot"]["tokens"].items():
            np.testing.assert_array_equal(t, case["sync"][rid, :len(t)])
        assert sorted(got["oneshot"]["tokens"]) == list(range(N_REQ))
        assert got["chunked"]["tokens"] == case["jvlm"]
        assert got["ngram"]["tokens"] == case["jvlm"]
        assert got["oneshot"]["attn"] == "gather:dense"
        assert got["chunked"]["attn"] == "torch-plain-paged:cpu"
        for name in ("oneshot", "chunked", "ngram"):
            run = got[name]
            assert run["layout"] == "split:modelx4"
            assert run["counts"]["whole_gathers"] == 0
            assert run["kv"] == cfg.n_kv_heads             # CACHE_KV whole
            assert run["wq"] == (cfg.n_layers, cfg.d_model, 1,
                                 cfg.resolved_head_dim)


def test_exit_decisions_equal_the_one_rank_port(case):
    """Each decode's depth for every row that emits and goes on, on the
    rank's data shard, equals the one-rank run's for that request and
    emission; the threshold splits the exits."""
    covered = set()
    for r in case["ranks"]:
        got = r["vlm"]["exit"]
        mesh, one = got["mesh"], got["one"]
        assert mesh["tokens"] == one["tokens"]
        assert mesh["depths"] and all(one["depths"][k] == d
                                      for k, d in mesh["depths"].items())
        covered |= set(mesh["depths"])
        assert set(one["depths"].values()) == {1, 2}       # mixed exits
        assert r["vlm"]["exit_gap"] > 1e-4
        assert mesh["layout"] == "split:modelx4"
        assert one["layout"] == "single"
    assert covered == set(case["ranks"][0]["vlm"]["exit"]["one"]["depths"])


def test_expert_mlp_streams_equal_jax(case):
    cfg = _cfg("qwen2-moe-a2.7b")
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    for r in case["ranks"]:
        got = r["moe"]
        assert got["routes"] == {"expert": None, "expert_mlp": "model"}
        assert got["w_gate"] == (cfg.n_layers, E, D, F // 4)
        assert got["tokens"] == case["jmoe"]
        assert got["counts"]["whole_gathers"] == 0
        assert got["layout"] == "split:modelx4"


# ------------------------------------------------------------ rank-free

def _range_case(seed=0, B=3, H=14, KV=2, hd=64, block=16, bpr=6, C=5):
    """internvl2-1b's full head geometry (14/2, hd 64) on a shuffled
    block table, decode lengths and chunk offsets of mixed depths."""
    rng = np.random.default_rng(seed)
    n_blocks = B * bpr + 3
    table = torch.tensor(rng.permutation(n_blocks)[:B * bpr]
                         .reshape(B, bpr), dtype=torch.int32)
    kp, vp = (torch.tensor(rng.standard_normal((n_blocks, block, KV, hd)),
                           dtype=torch.float32) for _ in range(2))
    q = torch.tensor(rng.standard_normal((B, C, H, hd)), dtype=torch.float32)
    lens = torch.tensor([1, 40, bpr * block], dtype=torch.int32)
    offs = torch.tensor([0, 37, bpr * block - C], dtype=torch.int32)
    return q, kp, vp, table, lens, offs


def _dense(kp, vp, table):
    """The same K/V as a dense view (its trash row last)."""
    from repro_torch.kernels.paged_attention.ref import gather_kv
    k, v = gather_kv(kp, vp, table)
    pad = torch.zeros((1,) + k.shape[1:])
    return kvc.DenseView(torch.cat([k, pad]), torch.cat([v, pad]))


@pytest.mark.parametrize("fn", ["paged_attention", "flash_prefill",
                                "flash_verify", "decode_attention",
                                "prefill_attention", "verify_attention"])
def test_every_head_range_of_a_14_2_split_7_ways(fn):
    """Two query heads a rank, ``q_head0`` in 0, 2, ..., 12: ranges 6-7
    straddle the two K/V heads. Each rank's call equals the whole call's
    heads."""
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    q, kp, vp, table, lens, offs = _range_case()
    view = _dense(kp, vp, table)
    calls = {
        "paged_attention": lambda q, **h: pa_ops.paged_attention(
            q[:, :1], kp, vp, table, lens, **h),
        "flash_prefill": lambda q, **h: fp_ops.flash_prefill(
            q, kp, vp, table, offs, **h),
        "flash_verify": lambda q, **h: fp_ops.flash_verify(
            q, kp, vp, table, offs, **h),
        "decode_attention": lambda q, **h: attention.decode_attention(
            q[:, :1], view, cur_len=lens, **h),
        "prefill_attention": lambda q, **h: attention.prefill_attention(
            q, view, q_off=offs, k_chunk=16, **h),
        "verify_attention": lambda q, **h: attention.verify_attention(
            q, view, q_off=offs, **h)}
    call = calls[fn]
    whole = call(q)
    H, m = q.shape[2], 7
    n = H // m
    for r in range(m):
        got = call(q[:, :, r * n:(r + 1) * n].contiguous(), q_head0=r * n,
                   n_heads=H)
        torch.testing.assert_close(got, whole[:, :, r * n:(r + 1) * n],
                                   rtol=TOL, atol=TOL)


@dataclasses.dataclass(frozen=True, eq=False)
class _Simulated(sh.ServeSplit):
    """One of ``size`` simulated ranks: its collectives record what the
    rank contributes, or hand back ``reply`` (the combined result of every
    rank's contribution)."""

    sent: list = dataclasses.field(default_factory=list)
    reply: object = None

    def _all_reduce(self, t):
        self.sent.append(t.clone())
        return t if self.reply is None else self.reply.clone()

    def _all_gather(self, t):
        self.sent.append(t.clone())
        if self.reply is None:
            return t.new_zeros((self.size * t.shape[0],) + t.shape[1:])
        return self.reply.clone()


def _simulate(m, fn, combine):
    """``fn(split)`` on each of m simulated ranks, twice: once to take
    each rank's contribution to its one collective, then with their
    ``combine``d result handed back, as the collective would."""
    sent = []
    for r in range(m):
        split = _Simulated(group=object(), size=m, rank=r)
        fn(split)
        sent.append(split.sent[0])
    reply = combine(sent)
    return [fn(_Simulated(group=object(), size=m, rank=r, reply=reply))
            for r in range(m)], sent


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_lookup_and_logits_gather(m):
    """The embedding looked up in each rank's rows (its part zero
    outside them) and summed equals the whole table's rows exactly, the
    padded vocabulary's last rows included; each rank's logit columns,
    gathered in rank order, give the whole logits, the same on every
    rank."""
    rng = np.random.default_rng(m)
    V, D = 24, 8
    table = torch.tensor(rng.standard_normal((V, D)), dtype=torch.float32)
    tokens = torch.tensor([[0, 5, 23, 6, 11], [12, 17, 18, 22, 1]])
    n = V // m
    outs, parts = _simulate(
        m, lambda s: s.embed(table[s.rank * n:(s.rank + 1) * n], tokens, V),
        lambda sent: sum(sent))
    for r, part in enumerate(parts):
        mine = (tokens >= r * n) & (tokens < (r + 1) * n)
        assert torch.equal(part[mine], table[tokens][mine])
        assert not part[~mine].any()
    for out in outs:
        assert torch.equal(out, table[tokens])
    x = torch.tensor(rng.standard_normal((3, 2, D)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((D, V)), dtype=torch.float32)
    whole = x @ w
    outs, _ = _simulate(
        m, lambda s: s.gather_vocab(whole[..., s.rank * n:(s.rank + 1) * n],
                                    V),
        lambda sent: torch.cat(sent))
    for out in outs:
        assert torch.equal(out, whole)
    # a rank holding every row and column does neither
    assert torch.equal(sh.WHOLE.embed(table, tokens, V), table[tokens])
    assert sh.WHOLE.gather_vocab(whole, V) is whole
