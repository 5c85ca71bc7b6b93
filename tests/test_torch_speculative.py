"""Speculative decoding in the port: against the JAX package, and the
reference's invariants pinned inside the port.

Against the JAX package (fp32 compute, the JAX weights through
``bridge.from_numpy``, numpy-seeded inputs):
- ``draft_ngram``: equal, integer for integer;
- ``accept``: (acc, nxt) equal under greedy and under temperature for
  the same logits and keys;
- ``verify_attention`` (gather, and the plain version of the ``cuda``
  path) and ``engine.verify_step`` logits: within 1e-5 absolute (fp32
  sums in another order; the largest difference seen is 2.3e-6 at
  logits of magnitude 0.6);
- the chunked paged scheduler's speculative streams, greedy and
  sampled, n-gram k in {1, 3} and the model drafter: equal, token for
  token.

Inside the port: greedy speculative streams equal the non-speculative
ones across k, both KV layouts and both attention paths; verify-window
logits equal W sequential decode steps within 1e-5 (on the CPU the
window's matmuls have W times the rows, which can take another BLAS
path, so the last bits may differ; the largest difference seen is
1.8e-7); EOS inside a window retires the slot in the same iteration;
``max_steps`` never clips a window; sampled streams are deterministic
per key and do not depend on the slot count; the refusals.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattention
from repro.models import model_zoo
from repro.serve import engine as jengine
from repro.serve import kv_cache as jkvc
from repro.serve import sampling as jsampling
from repro.serve import scheduler as jsched
from repro.serve import speculative as jspec
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention
from repro_torch.serve import engine, kv_cache as kvc
from repro_torch.serve import sampling
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib

SP = sampling.SamplingParams
JSP = jsampling.SamplingParams
LOGIT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _tkey(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _pair(arch="llama3.2-1b", attn=("xla", "gather"), seed=2):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype="float32", attn_impl=attn[0])
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32", attn_impl=attn[1])
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _prompts(cfg, n, seed, length=16, period=None):
    """n prompts of ``length`` tokens; with ``period``, each tiles one
    random segment of that many tokens (traffic the n-gram drafter
    accepts on)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if period is None:
            p = rng.integers(2, cfg.vocab, length)
        else:
            p = np.resize(rng.integers(2, cfg.vocab, period), length)
        out.append(p.astype(np.int32)[None])
    return out


KW = dict(n_slots=2, prompt_len=16, max_new_cap=12, eos_id=1, kv="paged",
          kv_block=4, prefill="chunked", chunk_tokens=5)


def _drive(mod, params, cfg, prompts, *, max_new=12, max_steps=None,
           **kw):
    """Submit all prompts (queueing past n_slots), drain; ({rid:
    tokens}, scheduler)."""
    sched = mod.DecodeScheduler(params, cfg, **{**KW, **kw})
    for rid, p in enumerate(prompts):
        sched.submit(p, max_new=max_new, request_id=rid)
    out, rounds = {}, 0
    while sched.pending:
        for f in sched.step(max_steps=max_steps):
            out[f.request_id] = np.asarray(f.tokens)
        rounds += 1
        assert rounds < 500
    return out, sched


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


# ------------------------------------------------------ units against JAX

@pytest.mark.parametrize("k,ngram", [(1, 1), (3, 2), (4, 3)])
def test_draft_ngram_equals_jax(k, ngram):
    """Random contexts with repetition (so matches exist), ragged prompt
    lengths and emission counts, including an empty emission buffer and
    a context that fills the buffers."""
    rng = np.random.default_rng(k * 10 + ngram)
    n, P, cap = 6, 12, 8
    for _ in range(5):
        prompt = rng.integers(2, 6, (n, P)).astype(np.int32)
        plens = rng.integers(1, P + 1, n).astype(np.int32)
        plens[0] = P
        out = rng.integers(2, 6, (n, cap)).astype(np.int32)
        ne = rng.integers(0, cap + 1, n).astype(np.int32)
        ne[1] = 0
        t0 = rng.integers(2, 6, n).astype(np.int32)
        want = jspec.draft_ngram(jnp.asarray(prompt), jnp.asarray(plens),
                                 jnp.asarray(out), jnp.asarray(ne),
                                 jnp.asarray(t0), k=k, ngram=ngram)
        got = spec_lib.draft_ngram(_t(prompt), _t(plens), _t(out), _t(ne),
                                   _t(t0), k=k, ngram=ngram)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draft_ngram_continues_repetition_and_falls_back():
    P = 8

    def pat(ph, n):
        return (2 + (ph + np.arange(n)) % P).astype(np.int32)
    out = np.full((1, 32), -1, np.int32)
    for ne in (0, 3, 9):
        o = out.copy()
        o[0, :ne] = pat(16, ne)
        props = spec_lib.draft_ngram(_t(pat(0, 16)[None]), _t([16]), _t(o),
                                     _t([ne]), _t([pat(16 + ne, 1)[0]]),
                                     k=4, ngram=2)
        np.testing.assert_array_equal(props[0].numpy(), pat(16 + ne + 1, 4))
    props = spec_lib.draft_ngram(torch.arange(2, 18)[None].int(), _t([16]),
                                 torch.full((1, 8), -1).int(), _t([0]),
                                 _t([99]), k=3, ngram=2)
    assert props[0].tolist() == [99, 99, 99]


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.8, 0), (0.8, 40),
                                        (1.5, 5)])
def test_accept_equals_jax(temp, top_k):
    """Logits built so that some drafts are likely (a boosted draft
    token), keys from ``window_keys``: the accepted length and the next
    token equal the JAX package's."""
    rng = np.random.default_rng(int(temp * 10) + top_k)
    n, k, V = 6, 4, 512
    for trial in range(4):
        drafts = rng.integers(0, V, (n, k)).astype(np.int32)
        logits = rng.standard_normal((n, k + 1, V)).astype(np.float32)
        boost = rng.random((n, k)) < 0.7
        for b in range(n):
            for j in range(k):
                if boost[b, j]:
                    logits[b, j, drafts[b, j]] += 6.0 + trial
        keys = jsampling.window_keys(
            jax.random.split(jax.random.PRNGKey(trial), n),
            jnp.asarray(rng.integers(0, 50, n), jnp.int32), k + 1)
        jacc, jnxt = jspec.accept(jnp.asarray(logits), jnp.asarray(drafts),
                                  keys, JSP(temperature=temp, top_k=top_k))
        acc, nxt = spec_lib.accept(_t(logits), _t(drafts),
                                   None if temp == 0 else _tkey(keys),
                                   SP(temperature=temp, top_k=top_k))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _paged_views(T=24, block=4, B=3, KV=2, D=64, seed=0):
    """The same paged cache contents in both packages (one layer),
    shuffled tables."""
    rng = np.random.default_rng(seed)
    bpr = T // block
    nb = B * bpr + 2
    kp = rng.standard_normal((1, nb, block, KV, D)).astype(np.float32)
    vp = rng.standard_normal((1, nb, block, KV, D)).astype(np.float32)
    table = rng.permutation(nb)[:B * bpr].reshape(B, bpr).astype(np.int32)
    j = jkvc.PagedKVCache(k_pool=jnp.asarray(kp), v_pool=jnp.asarray(vp),
                          table=jnp.asarray(table),
                          owner=jnp.zeros(nb, jnp.int32),
                          refcount=jnp.ones(nb, jnp.int32), max_len=T)
    pad = np.zeros((1, 1, block, KV, D), np.float32)
    t = kvc.PagedKVCache(_t(np.concatenate([kp, pad], 1)),
                         _t(np.concatenate([vp, pad], 1)), _t(table),
                         torch.zeros(nb, dtype=torch.int32),
                         torch.ones(nb, dtype=torch.int32), T)
    return j, t


@pytest.mark.parametrize("impl", [("xla", "gather"), ("pallas", "cuda")],
                         ids=["gather", "cuda-plain"])
def test_verify_attention_equals_jax(impl):
    """A window of W = 5 at ragged offsets (one past a block edge, one
    at 0) against the same cache: the gather path's decode-exact math,
    and the plain version of the flash_verify path."""
    jc, tc = _paged_views()
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 5, 8, 64)).astype(np.float32)
    q_off = np.array([0, 7, 19], np.int32)
    want = np.asarray(jattention.verify_attention(
        jnp.asarray(q), jc.view_at(0), q_off=jnp.asarray(q_off),
        attn_impl=impl[0]))
    got = attention.verify_attention(_t(q), tc.view(0), q_off=_t(q_off),
                                     attn_impl=impl[1])
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)


def _verify_inputs(cfg, tp, jp, jcfg, kv, W=4):
    """Caches of both packages prefilled with the same 10-token prompts,
    then one window of W tokens at cur_len 11 and 9."""
    rng = np.random.default_rng(3)
    prompts = rng.integers(2, cfg.vocab, (2, 10)).astype(np.int32)
    window = rng.integers(2, cfg.vocab, (2, W)).astype(np.int32)
    cur = np.array([11, 9], np.int32)
    jcache = jengine.make_cache(jcfg, 2, 24, kv_impl=kv, kv_block=4)
    tcache = engine.make_cache(cfg, 2, 24, kv_impl=kv, kv_block=4,
                               device="cpu")
    jnode = jcache["attn"].alloc(jnp.arange(2), jnp.full((2,), 24))
    jcache = {"attn": jnode}
    tcache["attn"].alloc(torch.arange(2), torch.full((2,), 24))
    for off in (0, 5):
        _, jcache = jengine.prefill_chunk(
            jp, jcfg, jnp.asarray(prompts), jcache,
            jnp.asarray([off, off], jnp.int32), chunk=5)
        engine.prefill_chunk(tp, cfg, _t(prompts), tcache,
                             _t(np.array([off, off], np.int32)), chunk=5)
    return window, cur, jcache, tcache


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("attn", [("xla", "gather"), ("pallas", "cuda")],
                         ids=["gather", "cuda-plain"])
def test_verify_step_logits_equal_jax(kv, attn):
    jcfg, jp, cfg, tp = _pair(attn=attn)
    window, cur, jcache, tcache = _verify_inputs(cfg, tp, jp, jcfg, kv)
    want, _ = jengine.verify_step(jp, jcfg, jnp.asarray(window), jcache,
                                  jnp.asarray(cur))
    got = engine.verify_step(tp, cfg, _t(window), tcache, _t(cur))
    assert got.shape == (2, window.shape[1], cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_verify_window_equals_sequential_decode_steps(kv):
    """Inside the port: position j of a verify window scores what a
    decode step at cur_len + j scores, within LOGIT_TOL, with the same
    argmax."""
    jcfg, jp, cfg, tp = _pair()
    window, cur, _, tcache = _verify_inputs(cfg, tp, jp, jcfg, kv)
    snap = [t.clone() for t in _cache_tensors(tcache)]
    got = engine.verify_step(tp, cfg, _t(window), tcache, _t(cur))
    for t, s in zip(_cache_tensors(tcache), snap):
        t.copy_(s)
    seq = [engine.decode_step(tp, cfg, _t(window[:, j:j + 1]), tcache,
                              _t(cur + j))[:, 0]
           for j in range(window.shape[1])]
    seq = torch.stack(seq, dim=1)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=LOGIT_TOL,
                               rtol=0)
    assert torch.equal(got.argmax(-1), seq.argmax(-1))


def _cache_tensors(cache):
    return [t for t in vars(cache["attn"]).values() if torch.is_tensor(t)]


# ----------------------------------------------- the scheduler against JAX

def _spec_pair(k, drafter="ngram", ngram=1):
    return (jspec.SpecConfig(k=k, drafter=drafter, ngram=ngram),
            spec_lib.SpecConfig(k=k, drafter=drafter, ngram=ngram))


@functools.lru_cache(maxsize=None)
def _draft_pair():
    """smollm-135m smoke drafting for llama3.2-1b smoke (both vocab 512)."""
    return _pair("smollm-135m", seed=99)


@pytest.mark.parametrize("case", ["greedy-k1", "greedy-k3", "sampled-k1",
                                  "sampled-k3-topk", "greedy-model",
                                  "sampled-model"])
def test_speculative_scheduler_equals_jax(case):
    jcfg, jp, cfg, tp = _pair()
    prompts = _prompts(cfg, 5, seed=7, period=4)
    k = 3 if "k3" in case or "model" in case else 1
    drafter = "model" if "model" in case else "ngram"
    jspec_cfg, spec = _spec_pair(k, drafter)
    temp = 0.8 if case.startswith("sampled") else 0.0
    top_k = 40 if "topk" in case else 0
    extra_j, extra_t = {}, {}
    if drafter == "model":
        djcfg, djp, dcfg, dtp = _draft_pair()
        extra_j = dict(draft_params=djp, draft_cfg=djcfg)
        extra_t = dict(draft_params=dtp, draft_cfg=dcfg)
    want, js = _drive(jsched, jp, jcfg, prompts, seed=3,
                      speculative=jspec_cfg,
                      sampling=JSP(temperature=temp, top_k=top_k), **extra_j)
    got, ts = _drive(sched_lib, tp, cfg, prompts, seed=3, speculative=spec,
                     sampling=SP(temperature=temp, top_k=top_k), **extra_t)
    _same(got, want)
    assert ts.spec_windows == js.spec_windows > 0
    assert ts.accepted_tokens == js.accepted_tokens
    assert ts.drafted_tokens == js.drafted_tokens == k * ts.spec_windows
    np.testing.assert_allclose(ts.slot_accept_len(), js.slot_accept_len())
    assert ts.total_steps == js.total_steps


# ----------------------------------------------- invariants inside the port

@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_greedy_speculative_equals_sequential_across_k(k):
    _, _, cfg, tp = _pair()
    prompts = _prompts(cfg, 3, seed=3, period=3)
    off, _ = _drive(sched_lib, tp, cfg, prompts)
    on, s = _drive(sched_lib, tp, cfg, prompts,
                   speculative=spec_lib.SpecConfig(k=k, ngram=1))
    _same(on, off)
    assert s.spec_windows > 0 and s.accepted_tokens > 0
    assert s.free_blocks == s.kv_blocks


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("attn", ["gather", "cuda"])
def test_greedy_speculative_equals_sequential_kv_and_attn(kv, attn):
    """Both KV layouts and both attention paths (``cuda``: the plain
    versions of flash_verify and paged_attention on the CPU), each
    speculative run against the sequential run of the same path; the
    kernel path never gathers."""
    _, _, cfg, tp = _pair()
    cfg = dataclasses.replace(cfg, attn_impl=attn)
    prompts = _prompts(cfg, 3, seed=4, period=4)
    off, _ = _drive(sched_lib, tp, cfg, prompts, kv=kv)
    g0 = kvc.PagedView.gather_calls
    on, s = _drive(sched_lib, tp, cfg, prompts, kv=kv,
                   speculative=spec_lib.SpecConfig(k=3, ngram=2))
    if attn == "cuda" and kv == "paged":
        assert kvc.PagedView.gather_calls == g0
        assert s.attn_impl == "torch-plain-verify-paged:cpu"
    _same(on, off)
    assert s.spec_windows > 0


def test_model_drafter_equals_sequential():
    """A draft MODEL with its own dense cache: an unrelated model's
    proposals cost iterations, never tokens; the target drafting for
    itself accepts every window in full."""
    _, _, cfg, tp = _pair()
    _, _, dcfg, dtp = _draft_pair()
    prompts = _prompts(cfg, 3, seed=6)
    off, _ = _drive(sched_lib, tp, cfg, prompts)
    spec = spec_lib.SpecConfig(k=2, drafter="model")
    on, s = _drive(sched_lib, tp, cfg, prompts, speculative=spec,
                   draft_params=dtp, draft_cfg=dcfg)
    _same(on, off)
    assert s.spec_windows > 0 and s.free_blocks == s.kv_blocks
    self_, s2 = _drive(sched_lib, tp, cfg, prompts, speculative=spec,
                       draft_params=tp, draft_cfg=cfg, eos_id=-1)
    off2, _ = _drive(sched_lib, tp, cfg, prompts, eos_id=-1)
    _same(self_, off2)
    # every window but a request's last (cut by its budget) accepts all k
    assert s2.accepted_tokens >= 2 * (s2.spec_windows - len(prompts))


def test_eos_inside_a_window_retires_the_slot_in_the_same_iteration():
    _, _, cfg, tp = _pair()
    prompts = _prompts(cfg, 4, seed=7, period=3)
    free, _ = _drive(sched_lib, tp, cfg, prompts, eos_id=-1)
    eos = int(free[0][2])
    spec = spec_lib.SpecConfig(k=4, ngram=1)
    off, _ = _drive(sched_lib, tp, cfg, prompts, eos_id=eos)
    on, s = _drive(sched_lib, tp, cfg, prompts, eos_id=eos,
                   speculative=spec)
    _same(on, off)
    assert any(len(t) < 12 for t in on.values())
    assert all(t[-1] == eos for t in on.values() if len(t) < 12)
    assert s.free_blocks == s.kv_blocks
    # the slot retired within the window that emitted EOS: no iteration
    # ran for it afterwards, so its windows fit its emissions
    assert s.spec_windows <= sum(len(t) for t in on.values())


def test_bounded_segments_never_clip_a_verify_window():
    """``max_steps`` pauses the loop between windows only: with the
    target drafting for itself (every window lands k+1 tokens) a capped
    drive gives the unbounded drive's streams and accept counts."""
    _, _, cfg, tp = _pair()
    prompts = _prompts(cfg, 3, seed=11)
    spec = spec_lib.SpecConfig(k=3, drafter="model")
    kw = dict(speculative=spec, draft_params=tp, draft_cfg=cfg)
    ref, s_ref = _drive(sched_lib, tp, cfg, prompts, **kw)
    out, s = _drive(sched_lib, tp, cfg, prompts, max_steps=2, **kw)
    _same(out, ref)
    assert s_ref.accepted_tokens > 0
    assert s.accepted_tokens == s_ref.accepted_tokens
    assert s.segments > s_ref.segments
    assert s.free_blocks == s.kv_blocks


def test_sampled_speculative_is_deterministic_and_slot_count_invariant():
    _, _, cfg, tp = _pair()
    prompts = _prompts(cfg, 4, seed=8, period=4)
    kw = dict(sampling=SP(temperature=0.8), seed=5,
              speculative=spec_lib.SpecConfig(k=3, ngram=2))
    a, sa = _drive(sched_lib, tp, cfg, prompts, **kw)
    b, _ = _drive(sched_lib, tp, cfg, prompts, **kw)
    c, _ = _drive(sched_lib, tp, cfg, prompts, n_slots=3, **kw)
    _same(a, b)
    _same(a, c)
    assert sa.spec_windows > 0


def test_spec_config_and_refusals():
    with pytest.raises(ValueError, match="k must be >= 1"):
        spec_lib.SpecConfig(k=0)
    with pytest.raises(ValueError, match="drafter"):
        spec_lib.SpecConfig(drafter="oracle")
    with pytest.raises(ValueError, match="ngram"):
        spec_lib.SpecConfig(ngram=0)
    _, _, cfg, tp = _pair()
    spec = spec_lib.SpecConfig(k=2)
    kw = dict(n_slots=2, prompt_len=16, max_new_cap=4, kv="paged",
              kv_block=4)
    with pytest.raises(ValueError, match="chunked"):
        sched_lib.DecodeScheduler(tp, cfg, **kw, speculative=spec)
    chunked = dict(kw, prefill="chunked", chunk_tokens=5)
    with pytest.raises(ValueError, match="draft_params"):
        sched_lib.DecodeScheduler(
            tp, cfg, **chunked,
            speculative=spec_lib.SpecConfig(k=2, drafter="model"))
    with pytest.raises(ValueError, match="drafter != 'model'"):
        sched_lib.DecodeScheduler(tp, cfg, **chunked, speculative=spec,
                                  draft_params=tp, draft_cfg=cfg)
    with pytest.raises(ValueError, match="need"):
        sched_lib.DecodeScheduler(tp, cfg, **chunked, draft_params=tp,
                                  draft_cfg=cfg)
    model = spec_lib.SpecConfig(k=2, drafter="model")
    with pytest.raises(ValueError, match="vocab"):
        spec_lib.validate(model, cfg, "chunked",
                          dataclasses.replace(cfg, vocab=cfg.vocab + 8), tp)
    with pytest.raises(ValueError, match="family"):
        spec_lib.validate(model, cfg, "chunked",
                          get_config("falcon-mamba-7b", smoke=True), tp)
    with pytest.raises(ValueError, match="attention-decoder"):
        engine.verify_step(tp, get_config("falcon-mamba-7b", smoke=True),
                           torch.zeros((1, 2), dtype=torch.long), {},
                           torch.ones(1, dtype=torch.int32))


def test_launcher_serves_sampled_and_speculative_on_cpu():
    out = launch_serve.main(
        ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--slots",
         "2", "--prompt-len", "8", "--requests", "3", "--rate", "1e9",
         "--max-new-short", "3", "--max-new-long", "6", "--kv", "paged",
         "--attn-impl", "cuda", "--prefill", "chunked", "--chunk-tokens",
         "4", "--eos-id", "-1", "--temperature", "0.8", "--top-k", "40",
         "--spec-k", "3", "--seed", "2"])
    assert out["tokens"] == 3 + 6 + 3
    assert out["spec_windows"] > 0
    assert out["drafted_tokens"] == 3 * out["spec_windows"]
    assert 0.0 <= out["accept_rate"] <= 1.0
    again = launch_serve.main(
        ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--slots",
         "2", "--prompt-len", "8", "--requests", "2", "--rate", "1e9",
         "--max-new-short", "3", "--max-new-long", "4", "--kv", "paged",
         "--prefill", "chunked", "--chunk-tokens", "4", "--eos-id", "-1",
         "--spec-k", "2", "--spec-drafter", "model", "--draft-arch",
         "smollm-135m"])
    assert again["tokens"] == 3 + 4 and again["spec_windows"] > 0
