"""The port's audio family (whisper-small smoke: 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 32 frames) against the JAX
package's: the sinusoids and the GELU MLP, the encoder, the full
forward and the cross K/V, the engine's prefill, decode and chunk
steps, the batch-synchronous loop, one-shot serving through the
scheduler, the SLO layer's preemption and the streaming front-end, on
the JAX package's own weights (``model_zoo.init_params`` through
``bridge.from_numpy``) and the same numpy inputs (token ids and
standard-normal frames from a seed), fp32 compute.

Tolerances: the same fp32 math contracted in another order is about
1e-6 apart; the encoder output and logits are held at 1e-4, the cached
K/V at 1e-4 of its largest entry (about 11 at the JAX init's scale), the
sinusoids at smoke width at 1e-6 (both round 10000 ** (2i/d) to
the same fp32 value there). Inside the port, paged against dense and
the chunked prefill against the one-shot one, at 1e-5 (the same ops on
another layout) or exactly where the reference pins it (token
streams). Token streams, loop counts and occupancy exactly.

What the JAX package refuses for the audio family (chunked admission,
the prefix cache, speculation, adaptive depth, disaggregation, a
request without frames) the port refuses with the same messages.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro.serve import speculative as jspec
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import adaptive, encdec, layers, model_zoo, \
    transformer
from repro_torch.serve import disagg, engine
from repro_torch.serve import frontend as fe_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import slo as slo_lib
from repro_torch.serve import speculative as spec_lib

ARCH = "whisper-small"
TOL = 1e-4
PROMPT, MAX_NEW = 12, 8
REQS = [(7, 5), (3, 8), (12, 4), (5, 6), (9, 7), (1, 3)]  # (len, max_new)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


def _close_scaled(ours, theirs, tol):
    """Within ``tol`` of the largest entry: the cross K/V and the self K/V
    reach about 11 at the JAX init's scale (``wk``/``wv`` drawn with the
    head count as fan-in), the encoder's 1e-5 differences with them."""
    scale = float(np.abs(np.asarray(theirs, np.float32)).max())
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=0, atol=tol * scale)


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax cfg, jax params, port cfg, port params) on the same weights,
    fp32 compute."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    jp = jax.jit(jzoo.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(5))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab, shape).astype(
        np.int32)


# ------------------------------------------------------------ the layers

def test_sinusoids_and_gelu_mlp_match_jax():
    _close(layers.sinusoidal_positions(37, 64), jlayers.sinusoidal_positions(
        37, 64), 1e-6)
    pos = np.array([0, 5, 31, 447], np.int32)
    _close(layers.sinusoid_at(_t(pos), 64),
           jlayers.sinusoid_at(jnp.asarray(pos), 64), 1e-6)
    one = layers.sinusoid_at(torch.tensor(17), 64)
    assert one.shape == (64,)
    _close(one, jlayers.sinusoid_at(17, 64), 1e-6)
    # full width: one fp32 rounding of 10000 ** (2i/d) apart, times the
    # position
    _close(layers.sinusoidal_positions(1500, 768),
           jlayers.sinusoidal_positions(1500, 768), 1e-4)
    rng = np.random.default_rng(1)
    x, w1, b1, w2, b2 = (rng.standard_normal(s).astype(np.float32) for s in
                         ((2, 3, 16), (16, 40), (40,), (40, 16), (16,)))
    _close(layers.gelu_mlp(*map(_t, (x, w1, b1, w2, b2)), torch.float32),
           jlayers.gelu_mlp(x, w1, b1, w2, b2, jnp.float32), 1e-5)


# ------------------------------------------------------- the param tree

def test_param_count_and_bridge_carry_every_leaf():
    """Same count as the JAX package at full width and smoke; the bridge
    carries every leaf of the JAX tree with its shape and values, every
    layer norm's weight and bias in the param dtype (fp32, as
    ``layers.layer_norm`` reads them) and every other leaf in bf16; the
    seeded draw has the JAX tree's structure."""
    for smoke in (False, True):
        assert model_zoo.count_params(get_config(ARCH, smoke=smoke)) == \
            jzoo.count_params(jax_get_config(ARCH, smoke=smoke))
    assert model_zoo.count_params(get_config(ARCH)) == 238_279_680
    jcfg = jax_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)      # bf16 compute
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == sum(1 for _ in transformer._leaves(tp))
    norms = []
    for path, leaf in jflat:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        name = path[-1].key
        keep = name.startswith(("ln", "enc_ln"))
        norms += [name] if keep else []
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
        torch.testing.assert_close(t, _t(leaf).to(t.dtype), rtol=0, atol=0)
    assert set(norms) == {"ln1", "ln1_b", "ln2", "ln2_b", "ln3", "ln3_b",
                          "enc_ln", "enc_ln_b", "ln_final", "ln_final_b"}
    seeded = bridge.init_params(cfg, seed=0, device="cpu")
    assert seeded["decoder"]["ln3_b"].dtype == torch.float32
    assert seeded["enc_ln_b"].dtype == torch.float32
    assert seeded["decoder"]["mlp"]["b_in"].dtype == torch.bfloat16
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, seeded))


# ------------------------------------------------------- the model

def test_encode_forward_and_cross_kv_match_jax():
    jcfg, jp, cfg, tp = _pair()
    frames = _frames(cfg, 2, 3)
    toks = _tokens(cfg, (2, 11), 3)
    jenc = jax.jit(jencdec.encode, static_argnums=1)(
        jp, jcfg, jnp.asarray(frames))
    enc = encdec.encode(tp, cfg, _t(frames))
    _close(enc, jenc, TOL)
    jl, jaux = jax.jit(jzoo.forward, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks),
                   "frames": jnp.asarray(frames)})
    tl, aux = model_zoo.forward(tp, cfg, {"tokens": _t(toks),
                                          "frames": _t(frames)})
    assert aux == {} and jaux == {}
    assert tl.shape == (2, 11, cfg.padded_vocab)
    _close(tl, jl, TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    jc = jencdec.cross_kv(jp, jcfg, jenc)
    c = encdec.cross_kv(tp, cfg, enc)
    for k in ("k", "v"):
        assert tuple(c[k].shape) == (cfg.n_layers, 2, cfg.n_frames,
                                     cfg.n_kv_heads, cfg.resolved_head_dim)
        _close_scaled(c[k], jc[k], TOL)


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_prefill_and_decode_match_jax(kv):
    """Prefill then four decode steps at per-row lengths: logits, the
    cross cache the prefill returns fresh, and the decoder's self K/V."""
    jcfg, jp, cfg, tp = _pair()
    B, S = 3, PROMPT
    prompts = _tokens(cfg, (B, S), 11)
    frames = _frames(cfg, B, 11)
    jcache = jengine.make_cache(jcfg, B, S + 6)
    jlog, jcache = jax.jit(jengine.prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(prompts), jcache,
        frames=jnp.asarray(frames))
    cache = engine.make_cache(cfg, B, S + 6, kv_impl=kv, kv_block=4,
                              device="cpu")
    assert engine.kv_key(cfg) == "self"
    if kv == "paged":
        cache["self"].alloc(torch.arange(B), torch.full((B,), S + 6))
    logits, fresh = engine.prefill(tp, cfg, _t(prompts), cache,
                                   frames=_t(frames))
    assert fresh.keys() == {"cross"}
    cache.update(fresh)
    _close(logits, jlog, TOL)
    for k in ("k", "v"):
        _close_scaled(cache["cross"][k], jcache["cross"][k], TOL)
    jstep = jax.jit(jengine.decode_step, static_argnums=1)
    cur = np.array([S + 1, S - 3, S + 1], np.int32)
    rng = np.random.default_rng(12)
    for t in range(4):
        tok = rng.integers(2, cfg.vocab, (B, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcfg, jnp.asarray(tok), jcache,
                             jnp.asarray(cur))
        logits = engine.decode_step(tp, cfg, _t(tok), cache, _t(cur))
        _close(logits, jlog, TOL)
        cur = cur + 1
    k = torch.stack([cache["self"].view(i).gather()[0]
                     for i in range(cfg.n_layers)])
    _close_scaled(k[:, :B, :S + 4],
                  np.asarray(jcache["self"].k)[:, :, :S + 4], TOL)


def test_prefill_and_decode_equal_the_full_forward():
    """As the reference's ``test_decode_matches_forward``: the prefill's
    last logits and one decode step's equal the teacher-forced forward at
    those positions (scalar ``cur_len``)."""
    _, _, cfg, tp = _pair()
    B, S = 2, 9
    toks = _tokens(cfg, (B, S + 1), 4)
    frames = _t(_frames(cfg, B, 4))
    full, _ = model_zoo.forward(tp, cfg, {"tokens": _t(toks),
                                          "frames": frames})
    cache = engine.make_cache(cfg, B, S + 4, device="cpu")
    pre, fresh = engine.prefill(tp, cfg, _t(toks[:, :S]), cache,
                                frames=frames)
    cache.update(fresh)
    _close(pre[:, -1], full[:, S - 1].numpy(), 1e-5)
    dec = engine.decode_step(tp, cfg, _t(toks[:, S:]), cache, S + 1)
    _close(dec[:, 0], full[:, S].numpy(), 1e-5)


@pytest.mark.parametrize("kv,attn_impl", [("dense", "gather"),
                                          ("paged", "gather"),
                                          ("paged", "cuda")],
                         ids=["dense", "paged-gather", "paged-plain-kernel"])
def test_prefill_chunk_equals_oneshot(kv, attn_impl):
    """The encoder-decoder's chunk mode against a cross cache a one-shot
    prefill primed (as the reference's
    ``test_audio_prefill_chunk_matches_oneshot_logits``): the chunked
    logits at every real position and the self K/V equal the one-shot
    prefill's. ``paged-plain-kernel`` attends through the flash-prefill
    kernel's plain version."""
    _, _, cfg, tp = _pair()
    c = dataclasses.replace(cfg, attn_impl=attn_impl)
    B, S, C = 2, 8, 3
    toks = _t(_tokens(cfg, (B, S), 6))
    frames = _t(_frames(cfg, B, 6))

    def cache_of():
        cache = engine.make_cache(c, B, S + 5, kv_impl=kv, kv_block=4,
                                  device="cpu")
        if kv == "paged":
            cache["self"].alloc(torch.arange(B), torch.full((B,), S + 5))
        return cache

    ref_cache = cache_of()
    ref, fresh = engine.prefill(tp, c, toks, ref_cache, frames=frames)
    cache = cache_of()
    cache["cross"] = fresh["cross"]
    got = torch.zeros_like(ref)
    for off in range(0, S, C):
        logits = engine.prefill_chunk(
            tp, c, toks, cache, torch.full((B,), off, dtype=torch.int32),
            chunk=C, mask=torch.ones(B, dtype=torch.bool))
        w = min(C, S - off)
        got[:, off:off + w] = logits[:, :w]
    _close(got, ref.numpy(), 1e-5)
    for i in range(cfg.n_layers):
        _close(cache["self"].view(i).gather()[0][:, :S],
               ref_cache["self"].view(i).gather()[0][:, :S].numpy(), 1e-5)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_generate_batch_sync_matches_jax(kv):
    jcfg, jp, cfg, tp = _pair()
    prompts = _tokens(cfg, (3, PROMPT), 12)
    frames = _frames(cfg, 3, 12)
    ref = jengine.generate_batch_sync(jp, jcfg, jnp.asarray(prompts),
                                      max_new=MAX_NEW, eos_id=1,
                                      frames=jnp.asarray(frames),
                                      kv_impl=kv, kv_block=4)
    ours = engine.generate_batch_sync(tp, cfg, _t(prompts), max_new=MAX_NEW,
                                      eos_id=1, frames=_t(frames),
                                      kv_impl=kv, kv_block=4)
    np.testing.assert_array_equal(ours.tokens.numpy(),
                                  np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert ours.attn_impl == f"gather:{kv}"


def test_paged_equals_dense_exactly():
    """Inside the port (as the reference's
    ``test_paged_matches_dense_across_families``): the paged self cache
    gives the dense one's tokens, and the paged kernel path (its plain
    version here) the gather path's."""
    _, _, cfg, tp = _pair()
    prompts = _t(_tokens(cfg, (2, 8), 13))
    frames = _t(_frames(cfg, 2, 13))
    runs = [engine.generate_batch_sync(
        tp, dataclasses.replace(cfg, attn_impl=impl), prompts, max_new=6,
        eos_id=-1, kv_impl=kv, kv_block=4, frames=frames)
        for kv, impl in (("dense", "gather"), ("paged", "gather"),
                         ("paged", "cuda"))]
    assert runs[2].attn_impl == "torch-plain-paged:cpu"
    for r in runs[1:]:
        torch.testing.assert_close(r.tokens, runs[0].tokens, rtol=0, atol=0)


# --------------------------------------------------------- the scheduler

def _requests(cfg, seed=13):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, cfg.vocab, (1, n)).astype(np.int32), m,
             rng.standard_normal((1, cfg.n_frames, cfg.d_model)).astype(
                 np.float32)) for n, m in REQS]


def _drive(sched, reqs):
    for rid, (p, m, f) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid, frames=f)
    return {f.request_id: np.asarray(f.tokens)
            for f in sched.run_until_drained()}


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_oneshot_scheduler_matches_jax_scheduler(kv):
    """Six ragged requests (1 to 12 tokens, bucketed to powers of two)
    into two slots: every stream, the loop iterations and the occupancy
    equal the JAX one-shot scheduler's; the paged pool gets every block
    back."""
    jcfg, jp, cfg, tp = _pair()
    reqs = _requests(cfg)
    kw = dict(n_slots=2, prompt_len=PROMPT, max_new_cap=MAX_NEW, eos_id=1,
              kv=kv, kv_block=4)
    js = jsched.DecodeScheduler(jp, jcfg, prefill="oneshot", **kw)
    ref = _drive(js, reqs)
    sched = sched_lib.DecodeScheduler(tp, cfg, **kw)
    assert sched._bucketed and sched._bucket(5) == 8
    ours = _drive(sched, reqs)
    assert sorted(ours) == sorted(ref) == list(range(len(REQS)))
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sched.total_steps == js.total_steps
    assert sched.occupancy == pytest.approx(js.occupancy)
    assert sched.tokens_emitted == js.tokens_emitted
    assert sched.loop_impl == "host-read"
    assert sched.attn_impl == f"gather:{kv}"
    assert sched.prefill_impl == "dense-bucketed"
    if kv == "paged":
        assert sched.free_blocks == sched.kv_blocks


def _reference(tp, cfg, reqs):
    """Uninterrupted FIFO streams on a roomy one-shot pool."""
    return _drive(sched_lib.DecodeScheduler(
        tp, cfg, n_slots=4, prompt_len=PROMPT, max_new_cap=MAX_NEW,
        eos_id=-1, kv="paged", kv_block=4), reqs)


def test_slo_preempted_request_equals_its_uninterrupted_stream():
    """Batch requests hold a one-shot pool of two residents; an
    interactive one arrives after two rounds and preempts one. The
    victim re-queues with its frames and replays its stream token for
    token; every stream equals the uninterrupted run's."""
    _, _, cfg, tp = _pair()
    reqs = _requests(cfg, seed=14)[:5]
    ref = _reference(tp, cfg, reqs)
    sched = sched_lib.DecodeScheduler(
        tp, cfg, n_slots=2, prompt_len=PROMPT, max_new_cap=MAX_NEW,
        eos_id=-1, kv="paged", kv_block=4)
    slo = slo_lib.SLOScheduler(sched, segment_steps=2)
    for rid, (p, m, f) in enumerate(reqs[:4]):
        slo.submit(p, max_new=m, slo_class="batch", request_id=rid,
                   frames=f)
    evs = slo.step() + slo.step()
    p, m, f = reqs[4]
    slo.submit(p, max_new=m, slo_class="interactive", request_id=4,
               frames=f)
    evs += slo.run_until_drained()
    got = {r: [] for r in range(5)}
    for e in evs:
        if e.kind in ("token", "finished"):
            got[e.request_id].extend(e.tokens)
    assert slo.preemptions > 0 and slo.replay_mismatches == 0
    assert slo.completed == 5
    for rid in range(5):
        np.testing.assert_array_equal(np.asarray(got[rid]), ref[rid])
    assert sched.free_blocks == sched.kv_blocks


def test_frontend_streams_carry_frames():
    """Two audio streams through the front-end, the scheduler stepped
    from a worker thread: each equals its uninterrupted stream."""
    _, _, cfg, tp = _pair()
    reqs = _requests(cfg, seed=15)[:2]
    ref = _reference(tp, cfg, reqs)

    async def one(fe, rid, out):
        p, m, f = reqs[rid]
        toks = []
        async for ev in fe.stream(p, max_new=m, request_id=rid, frames=f):
            if ev["event"] == "token":
                toks.extend(ev["tokens"])
        out[rid] = toks

    async def run():
        sched = sched_lib.DecodeScheduler(
            tp, cfg, n_slots=2, prompt_len=PROMPT, max_new_cap=MAX_NEW,
            eos_id=-1, kv="paged", kv_block=4)
        fe = fe_lib.StreamingFrontend(slo_lib.SLOScheduler(
            sched, segment_steps=4), max_inflight=4)
        out = {}
        await asyncio.gather(*[one(fe, r, out) for r in range(2)])
        return out

    out = asyncio.run(run())
    for rid in range(2):
        np.testing.assert_array_equal(np.asarray(out[rid]), ref[rid])


# ---------------------------------------------------------- refusals

def test_refusals_carry_the_reference_messages():
    """Chunked admission, the prefix cache and speculation: the JAX
    scheduler and the port's refuse with the same message, as they do a
    request without frames and frames on another family's pool;
    adaptive depth, the verify step and disaggregation refuse too."""
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
    p = np.ones((1, 4), np.int32)
    for mod, params, c in ((jsched, jp, jcfg), (sched_lib, tp, cfg)):
        sched = mod.DecodeScheduler(params, c, **kw)
        with pytest.raises(ValueError, match="every request needs frames"):
            sched.submit(p, max_new=2)
        with pytest.raises(ValueError, match="every request needs frames"):
            sched.submit(p, max_new=2, frames=np.zeros((1, 3, c.d_model)))
    dense = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                                compute_dtype="float32")
    sched = sched_lib.DecodeScheduler(
        bridge.init_params(dense, device="cpu"), dense, **kw)
    with pytest.raises(ValueError, match="frames invalid for family"):
        sched.submit(p, max_new=2, frames=_frames(cfg, 1, 0))
    for c in (dataclasses.replace(cfg, early_exit=True),
              dataclasses.replace(cfg, mod_capacity=0.5)):
        with pytest.raises(ValueError, match="attention-decoder family"):
            adaptive.validate(c)
    cache = engine.make_cache(cfg, 1, PROMPT, device="cpu")
    with pytest.raises(ValueError, match="verify_step requires"):
        engine.verify_step(tp, cfg, torch.ones((1, 2), dtype=torch.long),
                           cache, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs frames"):
        engine.prefill(tp, cfg, torch.ones((1, 2), dtype=torch.long), cache)
    with pytest.raises(ValueError, match="requires an attention-decoder"):
        disagg.DisaggScheduler(tp, cfg, n_prefill_slots=1, n_decode_slots=2,
                               prompt_len=PROMPT, max_new_cap=MAX_NEW)
