"""The port's mamba1 family (falcon-mamba-7b smoke) against the JAX
package's: the mixer under each scan path, the decode step, the block,
and the engine's prefill, decode and batch-synchronous generation, on
the JAX package's own weights (``model_zoo.init_params`` through
``bridge.from_numpy``) and the same numpy inputs.

The JAX ``"kernel"`` scan runs its Pallas kernel in interpret mode, as
the JAX package's own tests run it on the CPU; the port's ``"cuda"``
scan runs the kernel's plain version on CPU tensors.

Tolerances: fp32 compute agrees to about 1e-6 (the same math in
another order; the scans associate their products differently), held
to 2e-5 for the mixer and 1e-4 for logits. bf16 compute rounds at other
places in the two frameworks: 2e-2.
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
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.models import ssm, transformer
from repro_torch.serve import engine

RNG = np.random.default_rng(0)
JAX_SCAN = {"assoc": "assoc", "blocked": "blocked", "cuda": "kernel"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _pair(scan="assoc", compute="float32", chunk=8):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    def cfg_of(base, impl):
        return dataclasses.replace(
            base, compute_dtype=compute,
            ssm=dataclasses.replace(base.ssm, scan_impl=impl, chunk=chunk))
    jcfg = cfg_of(jax_get_config("falcon-mamba-7b", smoke=True),
                  JAX_SCAN[scan])
    cfg = cfg_of(get_config("falcon-mamba-7b", smoke=True), scan)
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(4))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            transformer.layer_params(tp["layers"])[i])


# ------------------------------------------------------------ the mixer

@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (64, 32)],
                         ids=["two-chunks", "odd-length", "four-subblocks"])
@pytest.mark.parametrize("scan", ["assoc", "blocked", "cuda"])
def test_mamba1_forward_matches_jax(scan, S, chunk):
    jcfg, jp, cfg, tp = _pair(scan, chunk=chunk)
    jl, tl = _layer(jp, tp)
    x = (0.5 * RNG.standard_normal((2, S, cfg.d_model))).astype(np.float32)
    jout, jst = jssm.mamba1_forward(jl["ssm"], jnp.asarray(x), jcfg,
                                    return_state=True)
    out, st = ssm.mamba1_forward(tl["ssm"], _t(x), cfg, return_state=True)
    _close(out, jout, 2e-5)
    _close(st["conv"], jst["conv"], 2e-5)
    _close(st["h"], jst["h"], 2e-5)
    assert st["h"].dtype == torch.float32


@pytest.mark.parametrize("scan", ["assoc", "cuda"])
def test_mamba1_forward_matches_jax_bf16(scan):
    jcfg, jp, cfg, tp = _pair(scan, compute="bfloat16")
    jl, tl = _layer(jp, tp)
    x = (0.5 * RNG.standard_normal((2, 16, cfg.d_model))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, jst = jssm.mamba1_forward(jl["ssm"], xb, jcfg, return_state=True)
    out, st = ssm.mamba1_forward(tl["ssm"], _t(x).to(torch.bfloat16), cfg,
                                 return_state=True)
    assert out.dtype == torch.bfloat16
    _close(out, jout.astype(jnp.float32), 2e-2)
    _close(st["h"], jst["h"], 2e-2)


def _state(cfg, n):
    return {"conv": RNG.standard_normal(
                (n, cfg.ssm.d_conv - 1, cfg.d_inner)).astype(np.float32),
            "h": RNG.standard_normal(
                (n, cfg.d_inner, cfg.ssm.d_state)).astype(np.float32)}


def test_mamba1_step_matches_jax():
    jcfg, jp, cfg, tp = _pair()
    jl, tl = _layer(jp, tp, 1)
    x = (0.5 * RNG.standard_normal((3, cfg.d_model))).astype(np.float32)
    st = _state(cfg, 3)
    jy, jnew = jssm.mamba1_step(jl["ssm"], jnp.asarray(x),
                                jax.tree.map(jnp.asarray, st), jcfg)
    y, new = ssm.mamba1_step(tl["ssm"], _t(x),
                             {k: _t(v) for k, v in st.items()}, cfg)
    _close(y, jy, 2e-5)
    _close(new["conv"], jnew["conv"], 2e-5)
    _close(new["h"], jnew["h"], 2e-5)


def test_mamba1_init_state_matches_jax():
    _, _, cfg, _ = _pair()
    jcfg = jax_get_config("falcon-mamba-7b", smoke=True)
    ours = ssm.mamba1_init_state(cfg, 3, "cpu")
    ref = jssm.mamba1_init_state(jcfg, 3)
    for k in ("conv", "h"):
        assert tuple(ours[k].shape) == ref[k].shape
        assert torch.count_nonzero(ours[k]) == 0
    assert ours["h"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_ssm_block_matches_jax(mode):
    jcfg, jp, cfg, tp = _pair("cuda")
    jl, tl = _layer(jp, tp, 2)
    S = 10 if mode == "full" else 1
    x = RNG.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 2) if mode == "decode" else None
    jx, jnew = jtransformer.ssm_block(
        jl, jnp.asarray(x), jcfg, None, mode=mode,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    ours_st = None if st is None else {k: _t(v) for k, v in st.items()}
    out = transformer.ssm_block(tl, _t(x), cfg, mode=mode, state=ours_st)
    _close(out, jx, 2e-5)
    if mode == "decode":      # the state was updated in place
        _close(ours_st["conv"], jnew["conv"], 2e-5)
        _close(ours_st["h"], jnew["h"], 2e-5)


def _counting_scan(monkeypatch, fn):
    """Route ``ssm.selective_scan`` through ``fn``, counting its calls."""
    calls = []

    def counted(*args):
        calls.append(tuple(args[4].shape))          # x: (B, Q, Di)
        return fn(*args)

    monkeypatch.setattr(ssm, "selective_scan", counted)
    return calls


def _chunk_chain(chunk):
    """The parent's call site, written out: the chunk loop of
    ``selective_scan_ref`` over contiguous copies of each chunk."""
    def chain(dt, A, B_, C_, x, h0):
        ys, h = [], h0
        for c in range(0, x.shape[1], chunk):
            sl = slice(c, c + chunk)
            y, h = selective_scan_ref(dt[:, sl].contiguous(), A,
                                      B_[:, sl].contiguous(),
                                      C_[:, sl].contiguous(),
                                      x[:, sl].contiguous(), h)
            ys.append(y)
        return torch.cat(ys, dim=1), h
    return chain


@pytest.mark.parametrize("S,chunk", [(16, 8), (64, 16), (13, 8)])
def test_mamba1_forward_cuda_scan_is_one_call(monkeypatch, S, chunk):
    """With ``scan_impl="cuda"`` the mixer makes one scan call over the
    whole sequence, whatever ``cfg.ssm.chunk``; the blocked scan keeps
    its chunk loop."""
    _, _, cfg, tp = _pair("cuda", chunk=chunk)
    tl = transformer.layer_params(tp["layers"])[0]
    x = _t((0.5 * RNG.standard_normal((2, S, cfg.d_model))
            ).astype(np.float32))
    calls = _counting_scan(monkeypatch, selective_scan_ref)
    ssm.mamba1_forward(tl["ssm"], x, cfg, return_state=True)
    assert calls == [(2, S, cfg.d_inner)]
    blocked = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, scan_impl="blocked"))
    ssm.mamba1_forward(tl["ssm"], x, blocked)
    assert len(calls) == 1


@pytest.mark.parametrize("S,chunk", [(16, 8), (64, 16), (24, 8)])
def test_mamba1_forward_cuda_scan_equals_chunk_chain(monkeypatch, S, chunk):
    """The one call over S equals, under ``torch.equal``, the chain of
    ``selective_scan_ref`` over S / chunk contiguous chunks that the call
    site made before: output, conv state and h."""
    _, _, cfg, tp = _pair("cuda", chunk=chunk)
    tl = transformer.layer_params(tp["layers"])[1]
    x = _t((0.5 * RNG.standard_normal((3, S, cfg.d_model))
            ).astype(np.float32))
    out, st = ssm.mamba1_forward(tl["ssm"], x, cfg, return_state=True)
    calls = _counting_scan(monkeypatch, _chunk_chain(chunk))
    ref, ref_st = ssm.mamba1_forward(tl["ssm"], x, cfg, return_state=True)
    assert len(calls) == 1
    assert torch.equal(out, ref)
    assert torch.equal(st["h"], ref_st["h"])
    assert torch.equal(st["conv"], ref_st["conv"])


def test_prefill_makes_one_scan_call_per_layer(monkeypatch):
    """One-shot prefill of a 16-token prompt (two chunks of 8): one scan
    call per layer, each over all 16 steps."""
    _, _, cfg, tp = _pair("cuda")
    calls = _counting_scan(monkeypatch, selective_scan_ref)
    prompts = _t(RNG.integers(2, cfg.vocab, (2, 16)).astype(np.int32))
    engine.prefill(tp, cfg, prompts, engine.make_cache(cfg, 2, 20,
                                                       device="cpu"))
    assert calls == [(2, 16, cfg.d_inner)] * cfg.n_layers


def test_bridge_keeps_recurrence_leaves_in_param_dtype():
    """In bf16 compute, A_log, dt_bias, D_skip and the block norm stay
    fp32 (the JAX package reads them in fp32), from the JAX tree and
    from a seed alike; the projections are cast once."""
    _, _, cfg, tp = _pair(compute="bfloat16")
    drawn = bridge.init_params(cfg, seed=0, device="cpu")
    for tree in (tp, drawn):
        lay = tree["layers"]
        for name in ssm.PARAM_DTYPE_LEAVES:
            assert lay["ssm"][name].dtype == torch.float32, name
        assert lay["ln"].dtype == torch.float32
        assert lay["ssm"]["in_proj"].dtype == torch.bfloat16
        assert lay["ssm"]["conv_w"].dtype == torch.bfloat16
    assert torch.count_nonzero(drawn["layers"]["ssm"]["dt_bias"]) == 0
    assert bool((drawn["layers"]["ssm"]["D_skip"] == 1).all())


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("scan", ["assoc", "cuda"])
def test_prefill_and_decode_step_logits_match_jax(scan):
    """A 16-token prefill (two chunks), then two decode steps against
    the prefilled state: logits and state agree at every step."""
    jcfg, jp, cfg, tp = _pair(scan)
    n = 3
    prompts = RNG.integers(2, cfg.vocab, (n, 16)).astype(np.int32)
    jcache = jengine.make_cache(jcfg, n, 20)
    tcache = engine.make_cache(cfg, n, 20, device="cpu")
    jl, jcache = jengine.prefill(jp, jcfg, jnp.asarray(prompts), jcache)
    tl, fresh = engine.prefill(tp, cfg, _t(prompts), tcache)
    _close(tl, jl, 1e-4)
    for k in ("conv", "h"):
        _close(fresh["ssm"][k], jcache["ssm"][k], 2e-5)
    tcache.update(fresh)
    tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1), np.int32)
    for cur in (17, 18):
        jl, jcache = jengine.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                         cur)
        tl = engine.decode_step(tp, cfg, _t(tok), tcache, cur)
        _close(tl, jl, 1e-4)
        _close(tcache["ssm"]["h"], jcache["ssm"]["h"], 2e-5)
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1), np.int32)


def test_decode_step_refuses_write_mask():
    _, _, cfg, tp = _pair()
    cache = engine.make_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="attention families"):
        engine.decode_step(tp, cfg, torch.zeros((2, 1), dtype=torch.long),
                           cache, 3, write_mask=torch.ones(2, dtype=bool))


@pytest.mark.parametrize("scan", ["blocked", "cuda"])
def test_generate_batch_sync_matches_jax(scan):
    jcfg, jp, cfg, tp = _pair(scan)
    prompt = RNG.integers(2, cfg.vocab, (3, 16)).astype(np.int32)
    ref = jengine.generate_batch_sync(jp, jcfg, jnp.asarray(prompt),
                                      max_new=10, eos_id=1)
    eos = int(np.asarray(ref.tokens)[1, 4])   # row 1 hits it mid-stream
    ref = jengine.generate_batch_sync(jp, jcfg, jnp.asarray(prompt),
                                      max_new=10, eos_id=eos)
    ours = engine.generate_batch_sync(tp, cfg, _t(prompt), max_new=10,
                                      eos_id=eos)
    np.testing.assert_array_equal(ours.tokens.numpy(),
                                  np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert ours.steps == int(ref.steps)
    assert ours.attn_impl == ours.prefill_impl == ref.attn_impl == \
        "attention-free"
