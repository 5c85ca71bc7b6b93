"""Serving the audio family on a model axis: ``DecodeScheduler(rules=,
mesh=)`` on the (4, 2) data x model mesh of 8 gloo CPU ranks, each rank
on its heads and MLP columns of whisper's encoder and decoder, its heads
of the self and cross K/V, and its vocabulary, against the JAX package.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
case; the JAX package's results are made in the same module fixture.
whisper-small smoke (2 + 2 layers, 4/4 heads of 16, d_ff 128, 32 frames,
padded vocab 512) in fp32 compute, on the JAX package's draws given to
the ranks as numpy arrays (``bridge.from_numpy``), with every leaf the
JAX init draws constant (the MLP biases, the layer norms' weights and
biases) given seeded noise: a ``b_out`` added on every rank instead of
once shows in the streams. Each rank holds 2 of the 4 heads of every
attention, 64 of the 128 MLP columns and 256 of the 512 embedding rows.

Six ragged requests (bucketed one-shot admission, each with its frames)
into 4 slots of a paged pool, through the paged kernel's plain version
(``attn_impl="cuda"``): the greedy streams equal the JAX package's
one-shot scheduler's exactly. Each rank's self K/V pool and cross K/V
hold its 2 heads (their DTensor views split over ``model``),
``whole_gathers`` is 0 and its parameter bytes are the rule-derived
figure exactly. On the ranks, the MLP on a rank's columns gives the
one-rank MLP (``b_out`` counted once) and the cross K/V a one-shot
admission splices is the rank's heads of the one-rank cross K/V.
"""

import dataclasses

import numpy as np
import pytest
import torch.utils._pytree as pytree

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import distributed

ARCH = "whisper-small"
MESH = (4, 2)
N_SLOTS, PROMPT, MAX_NEW = 4, 12, 6
REQS = [(7, 5), (3, 6), (12, 4), (5, 6), (9, 6), (1, 3)]  # (len, max_new)
# of the largest entry: the MLP's one sum over two ranks' parts in
# another order; the cross K/V after the encoder's two layers of such
# sums (about 2e-6 apart here)
TOL = {"mlp": 1e-6, "cross_kv": 1e-5}


def _cfg():
    return dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype="float32", attn_impl="cuda")


POOL = dict(n_slots=N_SLOTS, prompt_len=PROMPT, max_new_cap=MAX_NEW,
            eos_id=1, kv="paged", kv_block=4)


def _serve(sched, reqs):
    for rid, (p, m, f) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid, frames=f)
    return {f.request_id: [int(t) for t in f.tokens]
            for f in sched.run_until_drained()}


def _placements(t):
    return tuple(repr(p) for p in t.placements)


def _slice_checks(params, sched, cfg, frames):
    """(the largest relative difference of the rank's MLP from the one-rank
    MLP on the rank's columns, of the rank's cross K/V from its heads of
    the one-rank cross K/V)."""
    import torch
    from repro_torch.models import encdec, transformer
    split, local = sched._split, sched.params
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.standard_normal((2, 3, cfg.d_model))
                         .astype(np.float32))
    lp_whole = transformer.layer_params(params["decoder"])[0]
    lp_local = transformer.layer_params(local["decoder"])[0]
    want = encdec._mlp(lp_whole["mlp"], h, cfg)
    got = encdec._mlp(lp_local["mlp"], h, cfg, split)
    mlp = float(((got - want).abs() / want.abs().max()).max())
    enc = encdec.encode(params, cfg, frames)
    whole = encdec.cross_kv(params, cfg, enc)
    mine = encdec.cross_kv(local, cfg, encdec.encode(local, cfg, frames,
                                                     split))
    n = cfg.n_kv_heads // split.size
    heads = slice(split.rank * n, (split.rank + 1) * n)
    cross = max(float(((mine[k] - whole[k][..., heads, :]).abs()
                       / whole[k].abs().max()).max()) for k in ("k", "v"))
    return mlp, cross


def _ranks_case(np_params, reqs):
    """Runs on every rank of the launch."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_lib
    mesh = mesh_lib.make_mesh(MESH, ("data", "model"), "cpu")
    cfg = _cfg()
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    sh.reset_counts()
    s = sched_lib.DecodeScheduler(params, cfg,
                                  rules=model_zoo.make_rules(cfg, mesh),
                                  mesh=mesh, **POOL)
    tokens = _serve(s, reqs)
    counts = dict(sh.COUNTS)
    view = s.sharded_pool.cache
    return dict(
        rank=dist.get_rank(), tokens=tokens, counts=counts,
        layout=s.model_layout, attn=s.attn_impl,
        held=sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves(s.params)),
        self_kv=(int(s.pool.cache["self"].k_pool.shape[3]),
                 _placements(view["self"]["k_pool"])),
        cross={k: (tuple(v.shape), _placements(view["cross"][k]))
               for k, v in s.pool.cache["cross"].items()},
        checks=_slice_checks(params, s, cfg,
                             torch.from_numpy(reqs[0][2])))


def _noisy_constants(jp, seed):
    """Every leaf the JAX init draws constant (zeros, ones) plus seeded
    noise, the rest as drawn."""
    rng = np.random.default_rng(seed)
    flat, spec = pytree.tree_flatten(jp)
    flat = [a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
            if a.size > 1 and np.all(a == a.flat[0]) else a for a in flat]
    return pytree.tree_unflatten(flat, spec)


@pytest.fixture(scope="module")
def case():
    """The JAX package's streams, then the 8-rank launch."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.serve import scheduler as jsched
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype="float32")
    jp = _noisy_constants(jax.tree.map(np.asarray, jax.jit(
        jzoo.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(5))),
        5)
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(2, jcfg.vocab, (1, n)).astype(np.int32), m,
             rng.standard_normal((1, jcfg.n_frames, jcfg.d_model))
             .astype(np.float32)) for n, m in REQS]
    want = _serve(jsched.DecodeScheduler(jp, jcfg, prefill="oneshot",
                                         **POOL), reqs)
    ranks = distributed.run_local(_ranks_case, 8, jp, reqs, timeout=300)
    return {"want": want, "params": jp, "ranks": ranks}


def test_streams_equal_jax_on_a_model_axis(case):
    """Every rank emits the JAX package's one-shot streams, on the named
    split layout, with nothing whole, the parts summed and the logits
    gathered."""
    assert sorted(case["want"]) == list(range(len(REQS)))
    for r in case["ranks"]:
        assert r["tokens"] == case["want"]
        assert r["layout"] == f"split:modelx{MESH[1]}"
        assert r["attn"] == "torch-plain-paged:cpu"
        assert r["counts"]["whole_gathers"] == 0
        assert r["counts"]["split_all_reduces"] > 0
        assert r["counts"]["vocab_gathers"] > 0


def test_each_rank_holds_its_heads(case):
    """The self K/V pool and the cross K/V hold 2 of the 4 heads, their
    DTensor views split over ``data`` (blocks, slots) and over
    ``model`` (heads); the parameter bytes exactly the rule-derived
    figure: half of each leaf the rules split, every other leaf whole
    (the layer norms and ``b_out``)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    cfg = _cfg()
    m = MESH[1]
    kv = cfg.n_kv_heads // m
    rules = model_zoo.make_rules(cfg, {"data": MESH[0], "model": m})
    axes = {pytree.keystr(k): a for k, a in pytree.tree_flatten_with_path(
        model_zoo.param_axes(cfg),
        is_leaf=lambda a: isinstance(a, tuple))[0]}
    held, whole = 0, []
    for path, a in pytree.tree_flatten_with_path(case["params"])[0]:
        if sh._model_dim(rules, axes[pytree.keystr(path)],
                         a.shape) is None:
            held += a.size * 4
            whole.append(pytree.keystr(path))
        else:
            held += a.size * 4 // m
    assert whole and all("ln" in n or "b_out" in n for n in whole), whole
    cross = (cfg.n_layers, N_SLOTS // MESH[0], cfg.n_frames, kv,
             cfg.resolved_head_dim)
    for r in case["ranks"]:
        assert r["held"] == held
        assert r["self_kv"] == (kv, ("Shard(dim=1)", "Shard(dim=3)"))
        for k in ("k", "v"):
            assert r["cross"][k] == (cross, ("Shard(dim=1)",
                                             "Shard(dim=3)"))


@pytest.mark.parametrize("what", ["mlp", "cross_kv"])
def test_a_rank_computes_its_part(case, what):
    """On each rank, the MLP on its hidden columns (summed over the model
    axis, then ``b_out`` added once) gives the one-rank MLP, and the
    cross K/V of its heads the one-rank cross K/V's heads, within
    ``TOL`` of the largest entry."""
    i = {"mlp": 0, "cross_kv": 1}[what]
    for r in case["ranks"]:
        assert r["checks"][i] <= TOL[what], r["checks"]
