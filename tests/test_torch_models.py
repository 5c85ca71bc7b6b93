"""The port's layers, attention and dense transformer against the JAX
package's, on the same numpy inputs and the same weights
(``bridge.from_numpy`` of the JAX package's own draws).

Tolerances: fp32 compute agrees to about 1e-6 relative (the same math
summed in another order); the bounds below leave a margin of 10-50x.
bf16 compute rounds at other places in the two frameworks, so it is
held to a tolerance of a few bf16 ulps of the values compared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro.serve import kv_cache as jkvc
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention, layers, transformer
from repro_torch.models import model_zoo as zoo
from repro_torch.serve import engine, kv_cache as kvc

RNG = np.random.default_rng(0)
DENSE_IDS = tuple(a for a in ARCH_IDS if get_config(a).family == "dense")


def _rand(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------ layers

def test_norms_match_jax():
    x, w, b = _rand(3, 5, 48), _rand(48), _rand(48)
    _close(layers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w), 1e-5)
    _close(layers.layer_norm(_t(x), _t(w), _t(b)),
           jlayers.layer_norm(x, w, b), 1e-5)
    _close(layers.apply_norm("nonparametric_ln", _t(x), {}, "ln"),
           jlayers.apply_norm("nonparametric_ln", x, {}, "ln"), 1e-5)
    xb = _t(x).to(torch.bfloat16)
    _close(layers.rms_norm(xb, _t(w)),
           jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), w), 2e-2)


@pytest.mark.parametrize("theta", [10000.0, 500000.0, 1000000.0])
def test_rope_matches_jax(theta):
    x = _rand(2, 7, 4, 16)
    pos = RNG.integers(0, 3000, (2, 7)).astype(np.int32)
    _close(layers.rope(_t(x), _t(pos), theta),
           jlayers.rope(x, pos, theta), 2e-5)


def test_swiglu_matches_jax():
    x, g, u, d = _rand(2, 3, 16), _rand(16, 40), _rand(16, 40), \
        _rand(40, 16)
    _close(layers.swiglu(_t(x), _t(g), _t(u), _t(d), torch.float32),
           jlayers.swiglu(x, g, u, d, jnp.float32), 1e-4)


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("causal,skip,q_offset,valid", [
    (True, False, 0, None), (True, True, 0, None), (False, False, 0, 13),
    (True, False, 5, None)])
def test_chunked_attention_matches_jax(causal, skip, q_offset, valid):
    q, k, v = _rand(2, 20, 6, 8), _rand(2, 25, 2, 8), _rand(2, 25, 2, 8)
    kw = dict(causal=causal, q_chunk=8, k_chunk=6, q_offset=q_offset,
              kv_valid_len=valid, skip_masked_blocks=skip)
    _close(attention.chunked_attention(_t(q), _t(k), _t(v), **kw),
           jattn.chunked_attention(q, k, v, **kw), 2e-5)


def _dense_views(k, v):
    """The same K/V as a JAX DenseView and a port DenseView (whose
    layout carries one trash row)."""
    trash = np.zeros((1,) + k.shape[1:], np.float32)
    return (jkvc.DenseView(jnp.asarray(k), jnp.asarray(v)),
            kvc.DenseView(_t(np.concatenate([k, trash])),
                          _t(np.concatenate([v, trash]))))


def test_prefill_attention_gather_path_matches_jax():
    k, v = _rand(3, 24, 2, 8), _rand(3, 24, 2, 8)
    q = _rand(3, 6, 6, 8)
    off = np.array([0, 7, 18], np.int32)
    jv, tv = _dense_views(k, v)
    _close(attention.prefill_attention(_t(q), tv, q_off=_t(off),
                                       k_chunk=10),
           jattn.prefill_attention(q, jv, q_off=off, k_chunk=10), 2e-5)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_attention_gather_path_matches_jax(vector):
    k, v = _rand(3, 24, 2, 8), _rand(3, 24, 2, 8)
    q = _rand(3, 1, 6, 8)
    cur = np.array([1, 13, 24], np.int32) if vector else 17
    jv, tv = _dense_views(k, v)
    tcur = _t(cur) if vector else cur
    _close(attention.decode_attention(_t(q), tv, cur_len=tcur),
           jattn.decode_attention(q, jv, cur_len=cur), 2e-5)


# ------------------------------------------------------------- the model

_jit_init = jax.jit(model_zoo.init_params, static_argnums=0)
_jit_forward = jax.jit(jtransformer.forward, static_argnums=1)
_jit_zoo_forward = jax.jit(model_zoo.forward, static_argnums=1)
_jit_prefill_chunk = jax.jit(jengine.prefill_chunk, static_argnums=1,
                             static_argnames="chunk")
_jit_decode_step = jax.jit(jengine.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _pair(arch, compute="float32", attn_impl=None):
    """(jax cfg, jax params, port cfg, port params) on the same weights
    (cached: the tests below only read them)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    if attn_impl is not None:
        jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl[0])
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl[1])
    jp = _jit_init(jcfg, jax.random.PRNGKey(1))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_jax(arch):
    """Every family's full forward; the audio family's through
    ``model_zoo.forward`` with a batch of frames (its encoder's input)."""
    jcfg, jp, cfg, tp = _pair(arch)
    toks = RNG.integers(2, cfg.vocab, (2, 19)).astype(np.int32)
    if cfg.family == "audio":
        frames = _rand(2, cfg.n_frames, cfg.d_model)
        logits, _ = _jit_zoo_forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                                "frames": jnp.asarray(frames)})
        ours, _ = zoo.forward(tp, cfg, {"tokens": _t(toks),
                                        "frames": _t(frames)})
    else:
        logits, _ = _jit_forward(jp, jcfg, jnp.asarray(toks))
        ours, _ = transformer.forward(tp, cfg, _t(toks))
    assert ours.shape == (2, 19, cfg.padded_vocab)
    _close(ours, logits, 1e-4)


def test_forward_logits_match_jax_bf16():
    jcfg, jp, cfg, tp = _pair("llama3.2-1b", compute="bfloat16")
    toks = RNG.integers(2, cfg.vocab, (2, 19)).astype(np.int32)
    logits, _ = _jit_forward(jp, jcfg, jnp.asarray(toks))
    ours, _ = transformer.forward(tp, cfg, _t(toks))
    assert ours.dtype == torch.bfloat16
    # logits are O(1); a few bf16 ulps after 2 layers of bf16 rounding
    _close(ours, logits, 6e-2)


def test_bridge_casts_weights_once_and_keeps_norms_in_param_dtype():
    _, _, cfg, tp = _pair("llama3.2-1b", compute="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    assert tp["layers"]["ln_attn"].dtype == torch.float32
    assert tp["ln_final"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_draws_the_jax_tree(arch):
    """bridge.init_params gives the JAX package's names and shapes; the
    attention projections are drawn with fan-in d_model (unit-scale
    scores), which is the one scale that differs on purpose."""
    cfg = get_config(arch, smoke=True)
    ours = bridge.init_params(cfg, seed=0, device="cpu")
    ref = model_zoo.abstract_params(jax_get_config(arch, smoke=True))
    flat_ref = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_ours = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                 jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat_ours == flat_ref
    if cfg.family == "dense":
        wq = ours["layers"]["attn"]["wq"].float()
        assert wq.std().item() == pytest.approx(cfg.d_model ** -0.5,
                                                rel=0.1)


@pytest.mark.parametrize("arch,kv", [(a, "paged") for a in DENSE_IDS]
                         + [("llama3.2-1b", "dense")])
def test_prefill_chunk_and_decode_step_logits_match_jax(arch, kv):
    """Two ragged prefill chunks (a masked row in the second) then two
    decode steps at per-row depths, with the same cache layout in both
    packages: logits agree at every step."""
    jcfg, jp, cfg, tp = _pair(arch)
    n, W, C, max_len = 3, 10, 6, 20
    prompts = RNG.integers(2, cfg.vocab, (n, W)).astype(np.int32)
    jcache = jengine.make_cache(jcfg, n, max_len, kv_impl=kv, kv_block=4)
    tcache = engine.make_cache(cfg, n, max_len, kv_impl=kv, kv_block=4,
                               device="cpu")
    rows, budget = np.arange(n, dtype=np.int32), np.full(n, max_len,
                                                         np.int32)
    jcache["attn"] = jcache["attn"].alloc(jnp.asarray(rows),
                                          jnp.asarray(budget))
    tcache["attn"].alloc(_t(rows), _t(budget))
    for off, mask in ((np.zeros(n, np.int32), None),
                      (np.array([6, 6, 0], np.int32),
                       np.array([True, True, False]))):
        jl, jcache = _jit_prefill_chunk(
            jp, jcfg, jnp.asarray(prompts), jcache, jnp.asarray(off),
            chunk=C, mask=None if mask is None else jnp.asarray(mask))
        tl = engine.prefill_chunk(tp, cfg, _t(prompts), tcache, _t(off),
                                  chunk=C,
                                  mask=None if mask is None else _t(mask))
        _close(tl, jl, 1e-4)
    cur = np.array([11, 11, 7], np.int32)
    tok = RNG.integers(2, cfg.vocab, (n, 1)).astype(np.int32)
    for _ in range(2):
        jl, jcache = _jit_decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                         jnp.asarray(cur))
        tl = engine.decode_step(tp, cfg, _t(tok), tcache, _t(cur))
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1), np.int32)
        cur = cur + 1


def test_kernel_path_logits_match_jax_kernel_path():
    """attn_impl cuda (the plain versions on the CPU) against the JAX
    package's pallas path (interpret mode), through a paged cache."""
    jcfg, jp, cfg, tp = _pair("qwen2-7b", attn_impl=("pallas", "cuda"))
    n, W, C, max_len = 2, 8, 8, 14
    prompts = RNG.integers(2, cfg.vocab, (n, W)).astype(np.int32)
    jcache = jengine.make_cache(jcfg, n, max_len, kv_impl="paged",
                                kv_block=4)
    tcache = engine.make_cache(cfg, n, max_len, kv_impl="paged",
                               kv_block=4, device="cpu")
    budget = np.full(n, max_len, np.int32)
    jcache["attn"] = jcache["attn"].alloc(jnp.arange(n), budget)
    tcache["attn"].alloc(torch.arange(n), _t(budget))
    off = np.zeros(n, np.int32)
    jl, jcache = _jit_prefill_chunk(jp, jcfg, jnp.asarray(prompts),
                                       jcache, off, chunk=C)
    _close(engine.prefill_chunk(tp, cfg, _t(prompts), tcache, _t(off),
                                chunk=C), jl, 1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1), np.int32)
    cur = np.full(n, W + 1, np.int32)
    jl, _ = _jit_decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(cur))
    _close(engine.decode_step(tp, cfg, _t(tok), tcache, _t(cur)), jl, 1e-4)
