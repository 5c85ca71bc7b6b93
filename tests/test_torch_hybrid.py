"""The port's hybrid family (zamba2-1.2b smoke: mamba2 layers under one
shared attention block) against the JAX package's: the mamba2 mixer
and its decode step, the parameter tree, the full forward, the engine's
prefill and decode, and one-shot serving through the scheduler, on the
JAX package's own weights (``model_zoo.init_params`` through
``bridge.from_numpy``) and the same numpy inputs, fp32 compute.

Tolerances: the SSD products are the same fp32 math contracted in
another order, about 1e-6 apart; held at 1e-5 for the mixer and its
state and 1e-4 for logits. Token streams, loop counts and occupancy
exactly.

What the JAX package refuses for the hybrid (chunked prefill, the
prefix cache, speculation, adaptive depth) the port refuses with the
same messages; the launcher trains it (its loss and gradients are held
to the JAX package's in tests/test_torch_train.py).
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
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import adaptive, model_zoo, ssm, transformer
from repro_torch.serve import engine
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib

ARCH = "zamba2-1.2b"
TOL = 1e-4
PROMPT, MAX_NEW = 12, 8
REQS = [7, 3, 8, 5, 6, 4]                    # max_new of six requests


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _pair(**over):
    """(jax cfg, jax params, port cfg, port params) on the same weights,
    fp32 compute."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype="float32", **over)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32", **over)
    jp = jax.jit(jzoo.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(5))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            transformer.layer_params(tp["layers"])[i])


# ------------------------------------------------------------ the mixer

@pytest.mark.parametrize("B,S", [(2, 16), (2, 13), (4, 24)],
                         ids=["two-chunks", "odd-length-one-chunk",
                              "batch-4-three-chunks"])
def test_mamba2_forward_matches_jax(B, S):
    """The SSD mixer's output and its final state (conv and h), under
    the chunk rule: 16 and 24 steps are chunks of 8, 13 steps one chunk
    of 13."""
    jcfg, jp, cfg, tp = _pair()
    assert cfg.ssm.chunk == 8
    jl, tl = _layer(jp, tp, 1)
    x = (0.5 * np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)
    jout, jst = jssm.mamba2_forward(jl["ssm"], jnp.asarray(x), jcfg,
                                    return_state=True)
    out, st = ssm.mamba2_forward(tl["ssm"], _t(x), cfg, return_state=True)
    _close(out, jout, 1e-5)
    assert st["h"].dtype == torch.float32
    assert tuple(st["h"].shape) == (B, cfg.d_inner // cfg.ssm.head_dim,
                                    cfg.ssm.head_dim, cfg.ssm.d_state)
    _close(st["h"], jst["h"], 1e-5)
    _close(st["conv"], jst["conv"], 1e-5)


def test_mamba2_step_chain_equals_forward_and_jax_step():
    """S decode steps from the zero state give the forward's outputs and
    its final state; one step equals the JAX package's."""
    jcfg, jp, cfg, tp = _pair()
    jl, tl = _layer(jp, tp, 0)
    B, S = 3, 16
    x = (0.5 * np.random.default_rng(9).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)
    full, fst = ssm.mamba2_forward(tl["ssm"], _t(x), cfg, return_state=True)
    state = ssm.mamba2_init_state(cfg, B, "cpu")
    jstate = jssm.mamba2_init_state(jcfg, B)
    for t in range(S):
        if t == 5:
            jy, jstate = jssm.mamba2_step(jl["ssm"], jnp.asarray(x[:, t]),
                                          jax.tree.map(np.asarray, state),
                                          jcfg)
        y, state = ssm.mamba2_step(tl["ssm"], _t(x[:, t]), state, cfg)
        if t == 5:
            _close(y, jy, 1e-5)
            _close(state["h"], jstate["h"], 1e-5)
        _close(y, full[:, t].numpy(), 1e-5)
    _close(state["h"], fst["h"].numpy(), 1e-5)
    _close(state["conv"], fst["conv"].numpy(), 0)


# ------------------------------------------------------ the param tree

def test_param_count_and_bridge_carry_every_leaf():
    """Same count as the JAX package at full width and smoke; the
    bridge carries every leaf of the JAX tree, the one shared block
    unstacked, fp32 leaves where the JAX package reads fp32."""
    for smoke in (False, True):
        assert model_zoo.count_params(get_config(ARCH, smoke=smoke)) == \
            jzoo.count_params(jax_get_config(ARCH, smoke=smoke))
    jcfg = jax_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)      # bf16 compute
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == sum(1 for _ in transformer._leaves(tp))
    for path, leaf in jflat:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        name = path[-1].key
        keep = (name in ssm.PARAM_DTYPE_LEAVES + ssm.NORM_LEAVES
                or name.startswith("ln"))
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
        torch.testing.assert_close(t, _t(leaf).to(t.dtype), rtol=0, atol=0)
    assert tp["shared_attn"]["attn"]["wq"].dim() == 3
    seeded = bridge.init_params(cfg, seed=0, device="cpu")
    assert seeded["layers"]["ssm"]["norm_w"].dtype == torch.float32
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, seeded))


# ------------------------------------------------------ the full forward

@pytest.mark.parametrize("S,attn_impl", [(16, "gather"), (128, "cuda")],
                         ids=["chunked-attention", "flash-plain"])
def test_forward_matches_jax(S, attn_impl):
    """Logits within 1e-4 and identical greedy tokens; at S=128 under
    ``attn_impl="cuda"`` the shared block attends through the flash
    kernel's plain version (the JAX side through its XLA path)."""
    jcfg, jp, cfg, tp = _pair()
    toks = np.random.default_rng(S).integers(2, cfg.vocab, (2, S)).astype(
        np.int32)
    jl, jaux = jax.jit(jtransformer.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks))
    c = dataclasses.replace(cfg, attn_impl=attn_impl)
    if attn_impl == "cuda":
        assert transformer.resolved_full_attn_impl(c, S, "cpu") == \
            "torch-plain-flash:cpu"
    tl, aux = transformer.forward(tp, c, _t(toks))
    assert aux == {} and jaux == {}
    _close(tl, jl, TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_prefill_and_decode_match_jax(kv):
    """Prefill then four decode steps at per-row lengths: logits, the
    shared block's K/V in all its cache layers (one an application) and
    the mamba2 state."""
    jcfg, jp, cfg, tp = _pair()
    B, S = 3, PROMPT
    rng = np.random.default_rng(11)
    prompts = rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)
    jcache = jengine.make_cache(jcfg, B, S + 6)
    jlog, jcache = jax.jit(jengine.prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(prompts), jcache)
    cache = engine.make_cache(cfg, B, S + 6, kv_impl=kv, kv_block=4,
                              device="cpu")
    n_apps = -(-cfg.n_layers // cfg.shared_attn_every)
    assert engine._attn_layer_count(cfg) == n_apps == 2
    if kv == "paged":
        cache["attn"].alloc(torch.arange(B), torch.full((B,), S + 6))
        assert cache["attn"].k_pool.shape[0] == n_apps
    else:
        assert cache["attn"].k.shape[0] == n_apps
    logits, fresh = engine.prefill(tp, cfg, _t(prompts), cache)
    cache.update(fresh)
    _close(logits, jlog, TOL)
    _close(cache["ssm"]["h"], jcache["ssm"]["h"], 1e-5)
    jstep = jax.jit(jengine.decode_step, static_argnums=1)
    cur = np.full(B, S + 1, np.int32)
    for t in range(4):
        tok = rng.integers(2, cfg.vocab, (B, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcfg, jnp.asarray(tok), jcache,
                             jnp.asarray(cur))
        logits = engine.decode_step(tp, cfg, _t(tok), cache, _t(cur))
        _close(logits, jlog, TOL)
        cur = cur + 1
    _close(cache["ssm"]["h"], jcache["ssm"]["h"], 1e-5)
    _close(cache["ssm"]["conv"], jcache["ssm"]["conv"], 1e-5)
    k = torch.stack([cache["attn"].view(a).gather()[0]
                     for a in range(n_apps)])
    _close(k[:, :B, :S + 4], np.asarray(jcache["attn"].k)[:, :, :S + 4],
           TOL)


def test_generate_batch_sync_matches_jax():
    jcfg, jp, cfg, tp = _pair()
    prompts = np.random.default_rng(12).integers(
        2, cfg.vocab, (3, PROMPT)).astype(np.int32)
    ref = jengine.generate_batch_sync(jp, jcfg, jnp.asarray(prompts),
                                      max_new=MAX_NEW, eos_id=1)
    ours = engine.generate_batch_sync(tp, cfg, _t(prompts),
                                      max_new=MAX_NEW, eos_id=1)
    np.testing.assert_array_equal(ours.tokens.numpy(),
                                  np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))


# --------------------------------------------------------- the scheduler

def _drive(sched, prompts):
    for rid, (p, m) in enumerate(zip(prompts, REQS)):
        sched.submit(p[None], max_new=m, request_id=rid)
    return {f.request_id: np.asarray(f.tokens)
            for f in sched.run_until_drained()}


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_oneshot_scheduler_matches_jax_scheduler(kv):
    """Six exact-length requests into two slots (queueing, slot reuse):
    every stream, the loop iterations and the occupancy equal the JAX
    one-shot scheduler's; the paged pool gets every block back."""
    jcfg, jp, cfg, tp = _pair()
    prompts = np.random.default_rng(13).integers(
        2, cfg.vocab, (len(REQS), PROMPT)).astype(np.int32)
    kw = dict(n_slots=2, prompt_len=PROMPT, max_new_cap=MAX_NEW, eos_id=1,
              kv=kv, kv_block=4)
    js = jsched.DecodeScheduler(jp, jcfg, prefill="oneshot", **kw)
    ref = _drive(js, prompts)
    sched = sched_lib.DecodeScheduler(tp, cfg, **kw)
    ours = _drive(sched, prompts)
    assert sorted(ours) == sorted(ref) == list(range(len(REQS)))
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sched.total_steps == js.total_steps
    assert sched.occupancy == pytest.approx(js.occupancy)
    assert sched.tokens_emitted == js.tokens_emitted
    assert sched.loop_impl == "host-read"
    assert sched.attn_impl == f"gather:{kv}"
    if kv == "paged":
        assert sched.free_blocks == sched.kv_blocks
    with pytest.raises(ValueError, match="exact-length"):
        sched.submit(prompts[:1, :PROMPT - 1], max_new=2)


# ---------------------------------------------------------- refusals

def test_refusals_carry_the_reference_messages():
    """Chunked prefill, the prefix cache and speculation: the JAX
    scheduler and the port's refuse with the same message; adaptive
    depth and the engine's chunk and verify steps refuse too. The
    training launcher takes the hybrid (one step, a finite loss)."""
    from repro.serve import speculative as jspec
    jcfg, jp, cfg, tp = _pair()
    kw = dict(n_slots=2, prompt_len=PROMPT, max_new_cap=MAX_NEW)
    for extra, msg in (
            (dict(prefill="chunked"), "requires an attention-decoder"),
            (dict(prefix_cache=True, kv="paged"),
             "prefix_cache=True requires"),
            ("spec", "speculative decoding requires")):
        for mod, params, c, spec in ((jsched, jp, jcfg, jspec),
                                     (sched_lib, tp, cfg, spec_lib)):
            more = (dict(speculative=spec.SpecConfig(k=2))
                    if extra == "spec" else extra)
            with pytest.raises(ValueError, match=msg):
                mod.DecodeScheduler(params, c, **kw, **more)
    for c in (dataclasses.replace(cfg, early_exit=True),
              dataclasses.replace(cfg, mod_capacity=0.5)):
        with pytest.raises(ValueError, match="attention-decoder family"):
            adaptive.validate(c)
        cache = engine.make_cache(cfg, 1, PROMPT, device="cpu")
        with pytest.raises(ValueError, match="attention-decoder family"):
            engine.decode_step(tp, c, torch.ones((1, 1), dtype=torch.long),
                               cache, 1)
    cache = engine.make_cache(cfg, 1, PROMPT, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill requires"):
        engine.prefill_chunk(tp, cfg, torch.ones((1, 4), dtype=torch.long),
                             cache, torch.zeros(1, dtype=torch.int32),
                             chunk=4)
    with pytest.raises(ValueError, match="verify_step requires"):
        engine.verify_step(tp, cfg, torch.ones((1, 2), dtype=torch.long),
                           cache, torch.ones(1, dtype=torch.int32))
    out = launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1",
                             "--batch", "2", "--seq", "8",
                             "--device", "cpu"])
    assert np.isfinite(float(out["metrics"]["loss"]))


def test_launcher_serves_the_hybrid_oneshot(capsys):
    out = launch_serve.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--slots", "2",
         "--prompt-len", "8", "--requests", "3", "--rate", "1e9",
         "--max-new-short", "3", "--max-new-long", "5", "--eos-id", "-1"])
    assert out["tokens"] == 3 + 5 + 3
    assert out["attn_impl"] == "gather:dense"
    assert out["prefill_impl"] == "dense-bucketed"
    assert "zamba2" not in capsys.readouterr().err
