"""Sampled decoding in the port against the JAX package: the threefry
PRNG, the sampling policy and the scheduler's sampled streams.

Tolerances:
- ``fold_in``, ``random_bits``, ``uniform``, ``step_keys`` and
  ``window_keys``: bit for bit against ``jax.random`` (integer hashes,
  and a float made from the bits by a bit cast, a subtraction and an
  exact scale);
- the Gumbel noise ``-log(-log u)``: the two frameworks' ``log`` may
  differ by an ulp, so ``|port - jax| <= 2**-20 * max(1, |jax|)`` (about
  two fp32 ulps at magnitude 1-2; the largest difference seen on the
  CPU is 2**-21);
- sampled tokens (``categorical``, ``sample_slots``, the scheduler's
  streams): equal, token for token;
- ``filtered_logits``: equal, ``-inf`` where JAX has it.

The scheduler runs the smoke llama3.2-1b in fp32 with the JAX package's
weights (``bridge.from_numpy``), chunked and paged, 2 slots, 5 requests.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo
from repro.serve import sampling as jsampling
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import prng
from repro_torch.serve import sampling
from repro_torch.serve import scheduler as sched_lib

SP = sampling.SamplingParams
JSP = jsampling.SamplingParams
SEEDS = (0, 3, 21, 2**31 - 1)
SHAPES = ((), (3,), (4, 5), (128256,))
TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(jkey):
    """A JAX raw key as the port's int64 words."""
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _np(a):
    return np.asarray(a).astype(np.int64) if np.asarray(a).dtype.kind == "u" \
        else np.asarray(a)


# ------------------------------------------------------------------ PRNG

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_for_bit(seed):
    jk = _jkey(seed)
    tk = prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for data in (0, 1, 7, 1000, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      _np(jax.random.fold_in(jk, data)))
    # a batch of data against one key, and a batch of keys
    data = np.array([0, 5, 99, 2**30], np.int64)
    want = np.stack([_np(jax.random.fold_in(jk, int(d))) for d in data])
    np.testing.assert_array_equal(
        prng.fold_in(tk, torch.from_numpy(data)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_and_uniform_bit_for_bit(seed, shape):
    jk = jax.random.fold_in(_jkey(seed), 11)
    tk = _tkey(jk)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)))
    for lo in (0.0, TINY):
        got = prng.uniform(tk, shape, minval=lo).numpy()
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_an_ulp_and_categorical_equal(shape):
    jk = jax.random.PRNGKey(5)
    got = prng.gumbel(_tkey(jk), shape).numpy()
    want = np.asarray(jax.random.gumbel(jk, shape))
    assert np.all(np.abs(got - want)
                  <= 2.0**-20 * np.maximum(1.0, np.abs(want)))
    if shape:
        logits = np.random.default_rng(0).standard_normal(
            shape).astype(np.float32)
        assert int(prng.categorical(_tkey(jk), torch.from_numpy(logits))
                   .reshape(-1)[0]) == \
            int(jax.random.categorical(jk, logits.reshape(-1)))


def test_batched_draws_equal_per_row_draws():
    """A batch of keys draws each row from its own key, as ``jax.vmap``
    of a per-row draw does."""
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    logits = np.random.default_rng(1).standard_normal(
        (6, 97)).astype(np.float32)
    got = prng.categorical(_tkey(keys), torch.from_numpy(logits)).numpy()
    want = [int(jax.random.categorical(keys[i], logits[i]))
            for i in range(6)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", (0, 7))
def test_step_and_window_keys_bit_for_bit(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    tkeys = _tkey(keys)
    emitted = jnp.asarray([0, 1, 17, 63], jnp.int32)
    np.testing.assert_array_equal(
        sampling.step_keys(tkeys, torch.tensor([0, 1, 17, 63])).numpy(),
        _np(jsampling.step_keys(keys, emitted)))
    for first in ([0, 0, 0, 0], [1, 5, 17, 63]):
        got = sampling.window_keys(tkeys, torch.tensor(first), 6)
        want = jsampling.window_keys(keys, jnp.asarray(first, jnp.int32), 6)
        assert got.shape == (4, 6, 2)
        np.testing.assert_array_equal(got.numpy(), _np(want))
        for j in range(6):      # the window's keys ARE the step keys
            np.testing.assert_array_equal(
                got[:, j].numpy(),
                sampling.step_keys(tkeys, torch.tensor(first) + j).numpy())


# ------------------------------------------------------------- sampling

_TIE_CASES = (
    ([0.0, 1.0, 1.0, 1.0, -2.0], 2),          # three ties at the k-th value
    ([0.5001, 0.5002, 0.5003, 0.1, -1.0], 2),  # bf16 rounds them into ties
    ([0.0, 3.0, 2.0, 1.0, -2.0], 2),           # no ties
    ([1.0, 1.0, 1.0], 3),                      # k = vocab keeps everything
    ([2.0, 2.0, 0.5, 2.0, 2.0, -1.0], 3),
)


@pytest.mark.parametrize("case", range(len(_TIE_CASES)))
@pytest.mark.parametrize("bf16", [False, True])
def test_filtered_logits_equal_with_ties(case, bf16):
    vals, k = _TIE_CASES[case]
    logits = jnp.asarray(vals, jnp.bfloat16 if bf16 else jnp.float32)
    logits = logits.astype(jnp.float32)
    for temp in (1.0, 0.7):
        want = np.asarray(jsampling.filtered_logits(
            logits, JSP(temperature=temp, top_k=k)))
        got = sampling.filtered_logits(torch.from_numpy(np.array(logits)),
                                       SP(temperature=temp, top_k=k))
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(np.isfinite(want).sum()) == k


def test_top_k_keeps_exactly_k_under_ties_when_sampling():
    """Three logits tied at the k-th value: only the two lowest-index
    ties are ever drawn (the reference's regression)."""
    logits = torch.tensor([0.0, 1.0, 1.0, 1.0, -2.0])
    keys = _tkey(jax.random.split(jax.random.PRNGKey(0), 300))
    got = sampling.sample(logits.expand(300, 5), keys,
                          SP(temperature=1.0, top_k=2))
    assert set(got.tolist()) == {1, 2}


@pytest.mark.parametrize("temp,top_k", [(0.8, 0), (0.8, 40), (1.3, 7)])
def test_sample_slots_equal_jax(temp, top_k):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((5, 256))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    sp = dict(temperature=temp, top_k=top_k)
    want = np.asarray(jsampling.sample_slots(jnp.asarray(logits), keys,
                                             JSP(**sp)))
    got = sampling.sample_slots(torch.from_numpy(logits), _tkey(keys),
                                SP(**sp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_ignores_keys_and_top_k_is_checked():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert sampling.sample_slots(logits, None, SP()).tolist() == [1, 0]
    with pytest.raises(ValueError, match="top_k=5 exceeds"):
        sampling.sample_slots(torch.zeros(2, 4), None, SP(top_k=5))


# ------------------------------------------------------------- scheduler

@functools.lru_cache(maxsize=None)
def _pair(attn=("xla", "gather")):
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", smoke=True),
                               compute_dtype="float32", attn_impl=attn[0])
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", attn_impl=attn[1])
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _reqs(cfg):
    rng = np.random.default_rng(1)
    return [(rng.integers(2, cfg.vocab, (1, n)).astype(np.int32), m)
            for n, m in ((10, 7), (5, 8), (12, 3), (1, 6), (9, 8))]


KW = dict(n_slots=2, prompt_len=12, max_new_cap=8, eos_id=1, kv="paged",
          kv_block=4, prefill="chunked", chunk_tokens=5)


def _streams(mod, params, cfg, reqs, sp, **kw):
    sched = mod.DecodeScheduler(params, cfg, **{**KW, **kw}, sampling=sp)
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return {f.request_id: np.asarray(f.tokens)
            for f in sched.run_until_drained()}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("top_k", [0, 40])
@pytest.mark.parametrize("attn", [("xla", "gather"), ("pallas", "cuda")],
                         ids=["gather", "cuda"])
def test_scheduler_sampled_streams_equal_jax(seed, top_k, attn):
    """Per-request sampled streams (temperature 0.8) of the chunked paged
    scheduler equal the JAX scheduler's for the same seed."""
    jcfg, jp, cfg, tp = _pair(attn)
    reqs = _reqs(cfg)
    want = _streams(jsched, jp, jcfg, reqs,
                    JSP(temperature=0.8, top_k=top_k), seed=seed)
    got = _streams(sched_lib, tp, cfg, reqs,
                   SP(temperature=0.8, top_k=top_k), seed=seed)
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_oneshot_sampled_streams_equal_jax():
    jcfg, jp, cfg, tp = _pair()
    reqs = _reqs(cfg)
    kw = dict(prefill="oneshot", kv="dense", seed=3)
    sp = dict(temperature=0.8, top_k=40)
    want = _streams(jsched, jp, jcfg, reqs, JSP(**sp), **kw)
    got = _streams(sched_lib, tp, cfg, reqs, SP(**sp), **kw)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_explicit_keys_equal_jax_and_replace_the_derived_ones():
    jcfg, jp, cfg, tp = _pair()
    reqs = _reqs(cfg)[:3]
    keys = jax.random.split(jax.random.PRNGKey(77), len(reqs))
    out = {}
    for name, mod, params, c, sp in (
            ("jax", jsched, jp, jcfg, JSP(temperature=0.8)),
            ("port", sched_lib, tp, cfg, SP(temperature=0.8))):
        sched = mod.DecodeScheduler(params, c, **KW, sampling=sp)
        for rid, (p, m) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid,
                         key=keys[rid] if name == "jax"
                         else np.asarray(keys[rid]))
        out[name] = {f.request_id: np.asarray(f.tokens)
                     for f in sched.run_until_drained()}
    derived = _streams(sched_lib, tp, cfg, reqs, SP(temperature=0.8))
    for rid in out["jax"]:
        np.testing.assert_array_equal(out["port"][rid], out["jax"][rid])
    assert any(not np.array_equal(out["port"][r], derived[r])
               for r in derived)


def test_sampled_streams_are_deterministic_and_slot_count_invariant():
    """The same seed gives the same streams, whether the pool has 2 slots
    or 3 (slots and admission order move; keys do not)."""
    _, _, cfg, tp = _pair()
    reqs = _reqs(cfg)
    sp = SP(temperature=0.8, top_k=40)
    a = _streams(sched_lib, tp, cfg, reqs, sp, seed=5)
    b = _streams(sched_lib, tp, cfg, reqs, sp, seed=5)
    c = _streams(sched_lib, tp, cfg, reqs, sp, seed=5, n_slots=3)
    d = _streams(sched_lib, tp, cfg, reqs, sp, seed=6)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
        np.testing.assert_array_equal(a[rid], c[rid])
    assert any(not np.array_equal(a[r], d[r]) for r in a)
