"""The port's MoE family against the JAX package's, on the same numpy
inputs and the same weights (``bridge.from_numpy`` of the JAX package's
draws), in fp32 compute.

- ``moe.moe_mlp``: output and aux losses within 1e-5 (the same sums in
  another order agree to about 1e-6); the integer routing maps
  (``slot_token``, ``slot_entry``, ``token_slot``, ``dropped``) EQUAL,
  taken from the arguments of the JAX package's two gathers, in a
  prefill group that really drops (a lowered capacity factor) and in
  the decode regroup (S == 1, B > 1: one group of B tokens), at the
  smoke configs' routing and at qwen2-moe's full routing (60 experts,
  top-4) in a 128-token prefill chunk and the 8-slot decode regroup;
  every layer's drops equal through a 4-layer forward at the full
  routing; gradients of ``(out ** 2).sum() + load_balance`` within
  1e-4 of ``jax.grad``;
- ``model_zoo.forward``/``loss_fn`` for the qwen2-moe and dbrx smoke
  configs within 1e-4 (logits) and 1e-5 (loss, aux);
- the scheduler: the port's ``DecodeScheduler`` against the JAX one,
  one-shot and chunked (chunks of 3 and 8), token for token, and a pool
  of 12 slots under a rank-one router, where the decode regroup drops
  routed entries (asserted): the streams then depend on what every row
  feeds, retired and free rows included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo, moe
from repro_torch.serve import scheduler as sched_lib

MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(arch="qwen2-moe-a2.7b", capacity_factor=None, full_routing=False,
          n_layers=None):
    """(jax cfg, numpy params, port cfg, port params), fp32 compute.
    ``full_routing``: the full config's expert count, top-k and capacity
    factor at smoke widths (the routing shapes of the full config)."""
    def cut(c, full):
        m = c.moe
        if full_routing:
            m = dataclasses.replace(
                m, n_experts=full.moe.n_experts, top_k=full.moe.top_k,
                capacity_factor=full.moe.capacity_factor)
        if capacity_factor is not None:
            m = dataclasses.replace(m, capacity_factor=capacity_factor)
        return dataclasses.replace(c, compute_dtype="float32", moe=m,
                                   n_layers=n_layers or c.n_layers)

    jcfg = cut(jax_get_config(arch, smoke=True), jax_get_config(arch))
    cfg = cut(get_config(arch, smoke=True), get_config(arch))
    jp = jax.tree.map(np.asarray, jax.jit(jzoo.init_params,
                                          static_argnums=0)(
        jcfg, jax.random.PRNGKey(2)))
    return jcfg, jp, cfg, bridge.from_numpy(jp, cfg, device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"]["moe"])


def _jax_maps(monkeypatch, p, x, jcfg):
    """The JAX ``moe_mlp`` under ``jit``, its routing maps taken from
    the arguments of its dispatch and combine gathers (returned as
    outputs of the traced function)."""
    got = {}
    disp, comb = jmoe._dispatch_gather, jmoe._combine_gather

    def dispatch(xg_pad, slot_token, token_slot, dropped):
        got.update(slot_token=slot_token, token_slot=token_slot,
                   dropped=dropped)
        return disp(xg_pad, slot_token, token_slot, dropped)

    def combine(h_flat, token_slot, slot_entry, dropped):
        got["slot_entry"] = slot_entry
        return comb(h_flat, token_slot, slot_entry, dropped)

    monkeypatch.setattr(jmoe, "_dispatch_gather", dispatch)
    monkeypatch.setattr(jmoe, "_combine_gather", combine)

    def run(p, x):
        out, aux = jmoe.moe_mlp(p, x, jcfg)
        return out, aux, dict(got)

    out, aux, maps = jax.jit(run)(p, jnp.asarray(x))
    return out, aux, {k: np.asarray(v) for k, v in maps.items()}


def _port_maps(monkeypatch, p, x, cfg):
    got = {}
    route = moe.route

    def rec(expert_idx, E, C):
        maps = route(expert_idx, E, C)
        got.update(zip(("slot_token", "slot_entry", "token_slot",
                        "dropped"), (m.numpy() for m in maps)))
        return maps

    monkeypatch.setattr(moe, "route", rec)
    out, aux = moe.moe_mlp(p, _t(x), cfg)
    return out, aux, got


# (B, S, capacity factor, full routing, drops): a prefill group that
# drops, the default capacity, the decode regroup; then the full
# config's routing (60 experts, top-4) in a prefill chunk of 128 tokens
# (capacity 16) whose tokens share a component, as hidden states do
# (it drops), and in the decode regroup of 8 slots (capacity 8)
CASES = {"prefill-drops": (2, 32, 0.25, False, True),
         "prefill": (2, 12, None, False, False),
         "decode-regroup": (12, 1, None, False, False),
         "full-prefill-chunk": (1, 128, None, True, True),
         "full-decode-regroup": (8, 1, None, True, False)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_mlp_and_routing_maps_equal_jax(arch, case, monkeypatch):
    B, S, cf, full_routing, drops = CASES[case]
    jcfg, jp, cfg, tp = _pair(arch, cf, full_routing)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if full_routing:
        x += 2 * rng.standard_normal(cfg.d_model).astype(np.float32)
    jout, jaux, jmaps = _jax_maps(monkeypatch, _layer0(jp), x, jcfg)
    out, aux, maps = _port_maps(monkeypatch, _layer0(tp), x, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for k in ("moe_load_balance", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5)
    assert sorted(maps) == sorted(jmaps)
    for k in jmaps:
        np.testing.assert_array_equal(maps[k], jmaps[k], err_msg=k)
    n_drop = int(maps["dropped"].sum())
    assert (n_drop > 0) == drops
    if S == 1:                        # one group of B tokens
        assert maps["token_slot"].shape == (1, B, cfg.moe.top_k)
    if full_routing:
        E, C = cfg.moe.n_experts, moe._group_capacity(B * S, cfg)
        assert maps["slot_token"].shape == (1, E * (C + 1))
        if arch == "qwen2-moe-a2.7b":
            assert (E, C) == (60, 16 if S == 128 else 8)


@pytest.mark.parametrize("init", ["jax", "port"])
def test_full_routing_drops_equal_jax_through_the_forward(init,
                                                          monkeypatch):
    """qwen2-moe's routing (60 experts, top-4, capacity factor 1.25) at
    smoke widths, through a 4-layer forward of 2 random sequences of 128
    tokens (a group each, capacity 16, as a prefill chunk of 128), with
    the JAX package's init or the port's (``bridge.init_params``, as on
    the card): every layer's ``dropped`` map equals the JAX package's.
    The port's init draws ``wq``/``wk``/``wv`` with their true fan-in;
    the softer attention mixes the tokens' hidden states, the router
    follows what they share, and the groups overflow: more than a tenth
    of the routed entries drop, under a tenth with the JAX init."""
    jcfg, jp, cfg, tp = _pair(full_routing=True, n_layers=4)
    if init == "port":
        tp = bridge.init_params(cfg, seed=0, device="cpu")
        jp = jax.tree.map(lambda t: t.numpy(), tp)
    jcfg = dataclasses.replace(jcfg, layer_loop="unroll", remat="none")
    toks = np.random.default_rng(7).integers(
        2, cfg.vocab, (2, 128)).astype(np.int32)
    jdrops, drops = [], []
    disp, route = jmoe._dispatch_gather, moe.route

    def dispatch(xg_pad, slot_token, token_slot, dropped):
        jdrops.append(dropped)
        return disp(xg_pad, slot_token, token_slot, dropped)

    def rec(expert_idx, E, C):
        maps = route(expert_idx, E, C)
        drops.append(maps[3].numpy())
        return maps

    monkeypatch.setattr(jmoe, "_dispatch_gather", dispatch)
    monkeypatch.setattr(moe, "route", rec)
    jlogits, jd = jax.jit(lambda p, t: (jzoo.forward(p, jcfg, {
        "tokens": t})[0], list(jdrops)))(jp, jnp.asarray(toks))
    with torch.no_grad():
        logits, _ = model_zoo.forward(tp, cfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert len(drops) == len(jd) == 4
    for layer, (d, j) in enumerate(zip(drops, jd)):
        np.testing.assert_array_equal(d, np.asarray(j), err_msg=layer)
    assert (np.mean(drops) > 0.1) == (init == "port")


@pytest.mark.parametrize("cf", [None, 0.25])
def test_moe_gradients_equal_jax(cf):
    """d/d(x, params) of (out ** 2).sum() + load_balance, through the
    gathers' custom backwards, in a group with and without drops."""
    jcfg, jp, cfg, _ = _pair("qwen2-moe-a2.7b", cf)
    p = _layer0(jp)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_mlp(p, x, jcfg)
        return (out ** 2).sum() + aux["moe_load_balance"]

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    out, aux = moe.moe_mlp(tp, tx, cfg)
    ((out ** 2).sum() + aux["moe_load_balance"]).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-4)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(tp["router"].grad.abs().sum()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_forward_and_loss_equal_jax(arch):
    jcfg, jp, cfg, tp = _pair(arch)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    tbatch = {k: _t(v).long() for k, v in batch.items()}
    jlogits, jaux = jax.jit(jzoo.forward, static_argnums=1)(jp, jcfg,
                                                            batch)
    logits, aux = model_zoo.forward(tp, cfg, tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    jloss, jm = jax.jit(jzoo.loss_fn, static_argnums=1)(jp, jcfg, batch)
    loss, m = model_zoo.loss_fn(tp, cfg, tbatch)
    assert sorted(m) == sorted(jm) == ["ce", "loss", "moe_load_balance",
                                       "moe_z_loss"]
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS + ("internvl2-1b",))
def test_param_counts_equal_jax(arch):
    for smoke in (True, False):
        jcfg = jax_get_config(arch, smoke=smoke)
        cfg = get_config(arch, smoke=smoke)
        assert model_zoo.count_params(cfg) == jzoo.count_params(jcfg)
        assert model_zoo.count_active_params(cfg) == \
            jzoo.count_active_params(jcfg)


# ------------------------------------------------------ the scheduler

def _streams(mod, params, cfg, reqs, **kw):
    sched = mod.DecodeScheduler(params, cfg, **kw)
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return {f.request_id: np.asarray(f.tokens)
            for f in sched.run_until_drained()}, sched


def _reqs(cfg, n, plen, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, cfg.vocab, (1, plen)).astype(np.int32),
             int(rng.integers(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("mode", ["oneshot", "chunked-3", "chunked-8"])
def test_scheduler_equals_the_jax_scheduler(mode):
    """2 slots, 5 exact-length requests (queueing, slot reuse, ragged
    last chunks at chunk 8): streams equal token for token."""
    jcfg, jp, cfg, tp = _pair()
    kw = dict(n_slots=2, prompt_len=12, max_new_cap=8, eos_id=1,
              kv="paged", kv_block=4, prefill=mode.split("-")[0],
              **({"chunk_tokens": int(mode.split("-")[1])}
                 if "-" in mode else {}))
    reqs = _reqs(cfg, 5, 12)
    ref, js = _streams(jsched, jp, jcfg, reqs, **kw)
    ours, sched = _streams(sched_lib, tp, cfg, reqs, **kw)
    assert sorted(ours) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sched.total_steps == js.total_steps


@pytest.mark.parametrize("prefill", ["oneshot", "chunked"])
def test_decode_drops_with_more_than_8_slots(prefill, monkeypatch):
    """12 slots, 14 requests of mixed budgets under a rank-one router
    (every token goes to one of two expert pairs): the decode group of
    12 tokens overflows its capacity of 8, so which tokens keep their
    experts depends on every row's feed, the frozen tokens of retired
    slots and the zeros of prefilling ones included. The streams equal
    the JAX scheduler's."""
    jcfg, jp, cfg, _ = _pair()
    jp = jax.tree.map(np.copy, jp)
    rng = np.random.default_rng(3)
    L, D, E = jp["layers"]["moe"]["router"].shape
    jp["layers"]["moe"]["router"] = (
        rng.standard_normal((L, D, 1)).astype(np.float32)
        * np.linspace(3, -3, E).astype(np.float32)[None, None])
    tp = bridge.from_numpy(jp, cfg, device="cpu")
    drops = []
    route = moe.route

    def rec(expert_idx, E, C):
        maps = route(expert_idx, E, C)
        if expert_idx.shape[:2] == (1, 12):     # the decode regroup
            drops.append(int(maps[3].sum()))
        return maps

    monkeypatch.setattr(moe, "route", rec)
    kw = dict(n_slots=12, prompt_len=6, max_new_cap=8, eos_id=1,
              kv="paged", kv_block=4, prefill=prefill, chunk_tokens=3)
    reqs = _reqs(cfg, 14, 6, seed=3)
    ref, _ = _streams(jsched, jp, jcfg, reqs, **kw)
    ours, _ = _streams(sched_lib, tp, cfg, reqs, **kw)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sum(drops) > 0


def test_moe_refuses_padded_prompts_adaptive_depth_and_the_launcher():
    """Padded prompts stay refused. Adaptive depth and training are
    ported for the MoE and VLM families (tests/test_torch_adaptive.py,
    tests/test_torch_train.py): an early-exit config's full forward is
    the plain one, aux included. The launcher refuses no family any
    more: it trains the hybrid too (one step, a finite loss)."""
    _, _, cfg, tp = _pair()
    sched = sched_lib.DecodeScheduler(tp, cfg, n_slots=2, prompt_len=8,
                                      max_new_cap=4, prefill="chunked")
    with pytest.raises(ValueError, match="exact-length"):
        sched.submit(np.ones((1, 5), np.int32), max_new=2)
    ee = dataclasses.replace(cfg, early_exit=True, exit_threshold=1.0)
    batch = {"tokens": torch.ones((1, 4), dtype=torch.long)}
    (a, aux_a), (b, aux_b) = (model_zoo.forward(tp, c, batch)
                              for c in (ee, cfg))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert aux_a.keys() == aux_b.keys() == {"moe_load_balance",
                                            "moe_z_loss"}
    out = launch_train.main(["--arch", "zamba2-1.2b", "--smoke", "--steps",
                             "1", "--batch", "2", "--seq", "8",
                             "--device", "cpu"])
    assert np.isfinite(float(out["metrics"]["loss"]))
