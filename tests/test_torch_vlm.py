"""The port's VLM family (internvl2-1b smoke: the patch prefix) against
the JAX package's, on the same numpy inputs and weights, fp32 compute.

- ``model_zoo.forward``/``loss_fn`` with ``batch["patches"]``: logits
  within 1e-4, the loss (token positions only) within 1e-5;
- ``engine.generate_batch_sync(prefix_embeds=)`` equal to the JAX loop's
  tokens;
- the scheduler with ``prefix_len = n_patches``: one-shot and chunked
  (chunks of 3 and 8: a chunk straddles the patch/token boundary),
  token for token against the JAX scheduler, prompts of mixed lengths
  (VLM prompts are bucketed, as dense ones);
- the prefix cache (the JAX package's ``test_prefix_cache`` VLM cases):
  requests sharing an image hit its blocks and stream exactly as with
  the cache off and as the JAX scheduler with the cache on (hits and
  block tables equal); distinct images with one token prompt never hit;
- disaggregation: VLM requests prefilled on one tier and decoded on the
  other stream exactly as the colocated scheduler's, and the shipment
  covers the patch positions;
- the SLO layer: a preempted VLM request replays with its patches.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model_zoo
from repro_torch.serve import disagg as disagg_lib
from repro_torch.serve import engine
from repro_torch.serve import scheduler as sched_lib

ARCH = "internvl2-1b"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    jp = jax.tree.map(np.asarray, jax.jit(jzoo.init_params,
                                          static_argnums=0)(
        jcfg, jax.random.PRNGKey(2)))
    return jcfg, jp, cfg, bridge.from_numpy(jp, cfg, device="cpu")


def _patches(cfg, n, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.n_patches, cfg.d_model)).astype(np.float32)


def test_model_forward_and_loss_equal_jax():
    jcfg, jp, cfg, tp = _pair()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "patches": _patches(cfg, 2)}
    tbatch = {"tokens": _t(toks).long(),
              "labels": _t(batch["labels"]).long(),
              "patches": _t(batch["patches"])}
    jlogits, _ = jax.jit(jzoo.forward, static_argnums=1)(jp, jcfg, batch)
    logits, aux = model_zoo.forward(tp, cfg, tbatch)
    assert logits.shape == (2, cfg.n_patches + 10, cfg.padded_vocab)
    assert aux == {}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    jloss, _ = jax.jit(jzoo.loss_fn, static_argnums=1)(jp, jcfg, batch)
    loss, m = model_zoo.loss_fn(tp, cfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(m) == ["ce", "loss"]


def test_generate_batch_sync_equals_jax():
    jcfg, jp, cfg, tp = _pair()
    prompt = np.random.default_rng(6).integers(
        2, cfg.vocab, (2, 7)).astype(np.int32)
    pe = _patches(cfg, 2)
    ref = jengine.generate_batch_sync(jp, jcfg, prompt, max_new=6,
                                      eos_id=1, prefix_embeds=pe,
                                      kv_impl="paged", kv_block=4)
    got = engine.generate_batch_sync(tp, cfg, _t(prompt), max_new=6,
                                     eos_id=1, prefix_embeds=_t(pe),
                                     kv_impl="paged", kv_block=4)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(ref.tokens))


# ------------------------------------------------------ the scheduler

def _reqs(cfg, n=5, seed=5):
    rng = np.random.default_rng(seed)
    pe = _patches(cfg, n, seed)
    return [(rng.integers(2, cfg.vocab, (1, int(rng.integers(3, 13))))
             .astype(np.int32), int(rng.integers(3, 8)), pe[i:i + 1])
            for i in range(n)]


def _run(mod, params, cfg, reqs, **kw):
    kw = {"n_slots": 2, "prompt_len": 12, "max_new_cap": 8, "eos_id": 1,
          "kv": "paged", "kv_block": 4, "prefix_len": cfg.n_patches, **kw}
    sched = mod.DecodeScheduler(params, cfg, **kw)
    for rid, (p, m, pe) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid, prefix_embeds=pe)
    out = {}
    while sched.pending:
        for f in sched.step():
            out[f.request_id] = np.asarray(f.tokens)
    return out, sched


def _same(got, ref):
    assert sorted(got) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=str(rid))


@pytest.mark.parametrize("mode", ["oneshot", "chunked-3", "chunked-8"])
def test_scheduler_equals_the_jax_scheduler(mode):
    jcfg, jp, cfg, tp = _pair()
    kw = {"prefill": mode.split("-")[0]}
    if "-" in mode:
        kw["chunk_tokens"] = int(mode.split("-")[1])
    reqs = _reqs(cfg)
    ref, js = _run(jsched, jp, jcfg, reqs, **kw)
    got, sched = _run(sched_lib, tp, cfg, reqs, **kw)
    _same(got, ref)
    assert sched.total_steps == js.total_steps


def test_prefix_checks():
    _, _, cfg, tp = _pair()
    with pytest.raises(ValueError, match="prefix_len"):
        sched_lib.DecodeScheduler(tp, cfg, n_slots=1, prompt_len=8,
                                  max_new_cap=2, prefix_len=3)
    sched = sched_lib.DecodeScheduler(tp, cfg, n_slots=1, prompt_len=8,
                                      max_new_cap=2,
                                      prefix_len=cfg.n_patches)
    with pytest.raises(ValueError, match="prefix_embeds"):
        sched.submit(np.ones((1, 4), np.int32), max_new=2)
    plain = sched_lib.DecodeScheduler(tp, cfg, n_slots=1, prompt_len=8,
                                      max_new_cap=2)
    with pytest.raises(ValueError, match="prefix_len=0"):
        plain.submit(np.ones((1, 4), np.int32), max_new=2,
                     prefix_embeds=_patches(cfg, 1))


# ------------------------------------------------------ the prefix cache

PC = dict(prompt_len=16, max_new_cap=6, prefill="chunked", chunk_tokens=5)


def _image_reqs(cfg, images, prompts):
    pe = _patches(cfg, max(images) + 1, seed=11)
    return [(p[None], 6, pe[i:i + 1]) for i, p in zip(images, prompts)]


def test_prefix_cache_cold_and_warm_equal_cache_off_and_jax():
    """5 requests, 2 (image, prompt) pairs repeated, into 2 slots: the
    repeats map the shared blocks (patch blocks included) and stream as
    with the cache off; hits, evictions and block tables equal the JAX
    scheduler's round for round."""
    jcfg, jp, cfg, tp = _pair()
    rng = np.random.default_rng(7)
    a, b = (rng.integers(2, cfg.vocab, 16).astype(np.int32)
            for _ in range(2))
    reqs = _image_reqs(cfg, [0, 1, 0, 0, 1], [a, b, a, a, b])
    off, _ = _run(sched_lib, tp, cfg, reqs, **PC)
    on, s = _run(sched_lib, tp, cfg, reqs, prefix_cache=True, **PC)
    ref, js = _run(jsched, jp, jcfg, reqs, prefix_cache=True, **PC)
    _same(on, off)
    _same(on, ref)
    assert s.prefix_hit_blocks == js.prefix_hit_blocks > 0
    np.testing.assert_array_equal(s.pool.cache["attn"].table.numpy(),
                                  np.asarray(js.pool.cache["attn"].table))
    assert s.free_blocks == s.kv_blocks - len(s._prefix_index)


def test_distinct_images_never_hit():
    """One token prompt, two images: the chain seed differs at block 0,
    so nothing is shared (a text-only hash would serve the wrong
    image's K/V); n_slots=1 admits request 1 after request 0's entries
    are READY."""
    _, _, cfg, tp = _pair()
    a = np.random.default_rng(3).integers(2, cfg.vocab, 16).astype(np.int32)
    reqs = _image_reqs(cfg, [0, 1], [a, a])
    _, s = _run(sched_lib, tp, cfg, reqs, prefix_cache=True, n_slots=1,
                **PC)
    assert s.prefix_hit_blocks == 0
    # the same image twice does hit
    _, s = _run(sched_lib, tp, cfg, _image_reqs(cfg, [0, 0], [a, a]),
                prefix_cache=True, n_slots=1, **PC)
    assert s.prefix_hit_blocks > 0


# ------------------------------------------------------ disaggregation

def test_disaggregated_vlm_equals_colocated():
    _, _, cfg, tp = _pair()
    reqs = _reqs(cfg, n=4, seed=8)
    colo, _ = _run(sched_lib, tp, cfg, reqs, prefill="chunked",
                   chunk_tokens=5)
    d = disagg_lib.DisaggScheduler(
        tp, cfg, n_prefill_slots=2, n_decode_slots=2, prompt_len=12,
        max_new_cap=8, eos_id=1, kv_block=4, chunk_tokens=5,
        prefix_len=cfg.n_patches)
    for rid, (p, m, pe) in enumerate(reqs):
        d.submit(p, max_new=m, request_id=rid, prefix_embeds=pe)
    got = {f.request_id: np.asarray(f.tokens) for f in d.run_until_drained()}
    _same(got, colo)
    # each shipment carries the whole prefilled stream, patches included
    assert d.ship_cols * 4 >= 12 + cfg.n_patches
    assert d.transfers == len(reqs)


def test_slo_preemption_replays_a_vlm_request_with_its_patches():
    """One slot: a batch-class VLM request is preempted for an
    interactive one and replays from its prompt and its patches; every
    stream equals its uninterrupted one."""
    from repro_torch.serve import slo as slo_lib
    _, _, cfg, tp = _pair()
    reqs = _reqs(cfg, n=2, seed=12)
    alone = {rid: _run(sched_lib, tp, cfg, [r], n_slots=1, eos_id=-1,
                       prefill="chunked", chunk_tokens=5)[0][0]
             for rid, r in enumerate(reqs)}
    inner = sched_lib.DecodeScheduler(
        tp, cfg, n_slots=1, prompt_len=12, max_new_cap=8, eos_id=-1,
        kv="paged", kv_block=4, prefill="chunked", chunk_tokens=5,
        prefix_len=cfg.n_patches)
    slo = slo_lib.SLOScheduler(inner, segment_steps=2)
    (p0, m0, pe0), (p1, m1, pe1) = reqs
    slo.submit(p0, max_new=m0, slo_class="batch", request_id=0,
               prefix_embeds=pe0)
    events = []
    while not len(inner.emitted(0)):
        events += slo.step()
    slo.submit(p1, max_new=m1, slo_class="interactive", request_id=1,
               prefix_embeds=pe1)
    while slo.pending:
        events += slo.step()
        assert slo.rounds < 100
    assert slo.preemptions == 1 and slo.replay_mismatches == 0
    got = {e.request_id: np.asarray(e.finished.tokens) for e in events
           if e.kind == "finished"}
    _same(got, alone)
