"""Adaptive per-token depth (early exit and mixture-of-depths) in the
port, against the JAX package and pinned inside the port.

Against the JAX package (its own weights through ``bridge.from_numpy``,
the same numpy inputs, fp32 compute): ``exit_margin``,
``make_halt_fn``, ``mod_apply_full`` and ``mod_apply_decode``; one
``decode_step(with_depth=True, live=...)`` whose rows halt at different
layers (dense, MoE and VLM); the toy-stack ``decode_layers`` (monotone
halt, fill coverage, live rows starting halted); the mixture-of-depths
full forward (the MoE's aux too); an MoE decode whose halted rows are
still routed and take expert capacity (every layer's routing maps);
the chunked scheduler under early exit for the MoE and for a VLM pool
with its patch prefix.
Tolerances: fp32 sums in another order agree to about 1e-6 relative,
held at 1e-4 (logits, margins) and 1e-5 (the router's blend); halt
bits, depth vectors and the toy stack's values exactly.

Inside the port, bit for bit: threshold inf against the non-adaptive
path (batch-synchronous, and through the scheduler with 8 requests
into 2 slots); exit at an identity tail against full depth and against
a host-truncated model; depth statistics; the router's gradient; the
scheduler against the batch-synchronous loop under mixture-of-depths;
the launch count that stands in for the JAX package's
``check_depth_gating`` (on the CPU, calls of
``attention.decode_attention``); ``validate``'s refusals; the launcher's
``--early-exit --compare`` report.

The tests marked ``cuda`` run the graph lowering (an IF node a layer
inside a captured segment) against the host-read one on the card, for
the dense family and for the MoE (its routing inside the segment):

    python -m pytest --noconftest -m cuda tests/test_torch_adaptive.py

JAX is imported only inside the tests that hold the port to it, so the
``cuda`` tests run on a machine with only PyTorch.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import bridge, core
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import adaptive, attention, model_zoo, transformer
from repro_torch.serve import engine
from repro_torch.serve import scheduler as sched_lib

PROMPT, MAX_NEW, SLOTS = 16, 8, 2
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import adaptive as jadaptive
    from repro.models import model_zoo as jzoo
    from repro.models import transformer as jtransformer
    from repro.serve import engine as jengine
    return dict(jax=jax, jnp=jnp, get_config=jax_get_config,
                adaptive=jadaptive, zoo=jzoo, transformer=jtransformer,
                engine=jengine)


@functools.lru_cache(maxsize=None)
def _pair(arch, **over):
    """(jax cfg, jax params, port cfg, port params): the JAX package's
    draws on both sides, fp32 compute."""
    J = _jax()
    jcfg = dataclasses.replace(J["get_config"](arch, smoke=True),
                               compute_dtype="float32", **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32", **over)
    jp = J["jax"].jit(J["zoo"].init_params, static_argnums=0)(
        jcfg, J["jax"].random.PRNGKey(3))
    return jcfg, jp, cfg, bridge.from_numpy(
        J["jax"].tree.map(np.asarray, jp), cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _model(arch="llama3.2-1b", **over):
    """Port config and random weights (fp32 compute)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32", **over)
    return cfg, bridge.init_params(cfg, seed=0, device="cpu")


def _prompts(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab, (n, PROMPT)).astype(np.int32)


def _identity_tail(params, e):
    """Zero ``wo`` and ``w_down`` from layer ``e`` on: both residual
    branches add exact zeros, so those layers are identities."""
    out = dict(params)
    lay = out["layers"] = dict(params["layers"])
    lay["attn"], lay["mlp"] = dict(lay["attn"]), dict(lay["mlp"])
    for tree, name in ((lay["attn"], "wo"), (lay["mlp"], "w_down")):
        tree[name] = tree[name].clone()
        tree[name][e:] = 0
    return out


def _sync(params, cfg, prompts, **kw):
    return engine.generate_batch_sync(params, cfg, _t(prompts),
                                      max_new=MAX_NEW, eos_id=1, **kw)


def _through_scheduler(params, cfg, prompts, eos_id=1, **kw):
    sched = sched_lib.DecodeScheduler(
        params, cfg, n_slots=SLOTS, prompt_len=PROMPT, max_new_cap=MAX_NEW,
        eos_id=eos_id, **kw)
    for rid, p in enumerate(prompts):
        sched.submit(p[None, :], max_new=MAX_NEW, request_id=rid)
    return sched, {f.request_id: f for f in sched.run_until_drained()}


# ------------------------------------------------ the functions, against JAX

@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-1b", "qwen2-7b",
                                  "qwen2-moe-a2.7b", "internvl2-1b"])
def test_exit_margin_and_halt_fn_match_jax(arch):
    """The margin over the padded vocab (tied unembed for smollm and
    llama, untied for the others), at the last of 3 positions; the halt bits
    at a threshold between two margins, under and over the layer
    floor."""
    J = _jax()
    jcfg, jp, cfg, tp = _pair(arch)
    x = np.random.default_rng(1).standard_normal(
        (6, 3, cfg.d_model)).astype(np.float32)
    ref = np.asarray(J["adaptive"].exit_margin(jp, jcfg, J["jnp"].asarray(x)))
    ours = adaptive.exit_margin(tp, cfg, _t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    s = np.sort(ref)
    k = int(np.argmax(np.diff(s)))
    thr = float(s[k] + s[k + 1]) / 2
    for i in (0, 2):
        over = dict(early_exit=True, exit_threshold=thr, exit_min_layers=2)
        jh = J["adaptive"].make_halt_fn(jp, dataclasses.replace(jcfg, **over))
        th = adaptive.make_halt_fn(tp, dataclasses.replace(cfg, **over))
        want = np.asarray(jh(J["jnp"].asarray(x), i))
        np.testing.assert_array_equal(th(_t(x), i).numpy(), want)
        assert want.any() == (i + 1 >= 2)
    assert adaptive.make_halt_fn(tp, cfg) is None


@pytest.mark.parametrize("routed", [True, False])
def test_mod_apply_full_and_decode_match_jax(routed):
    J = _jax()
    jnp = J["jnp"]
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              mod_capacity=0.5, mod_every=2)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.3
    i = 1 if routed else 0
    x_in, x_out = (rng.standard_normal((8, 7, cfg.d_model)).astype(
        np.float32) for _ in range(2))
    ref = J["adaptive"].mod_apply_full({"w": jnp.asarray(w)},
                                       jnp.asarray(x_in), jnp.asarray(x_out),
                                       i, cfg)
    ours = adaptive.mod_apply_full({"w": _t(w)}, _t(x_in), _t(x_out), i, cfg)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    d_in, d_out = x_in[:, -1:], x_out[:, -1:]
    rx, rapp = J["adaptive"].mod_apply_decode(
        {"w": jnp.asarray(w)}, jnp.asarray(d_in), jnp.asarray(d_out), i, cfg)
    tx, tapp = adaptive.mod_apply_decode({"w": _t(w)}, _t(d_in), _t(d_out),
                                         i, cfg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(rx), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(rapp)
    if routed:
        assert want.any() and not want.all()    # the gate splits the rows
        np.testing.assert_array_equal(tapp.numpy(), want)
    else:
        assert tapp is None and want.all()


def _jax_decode(J, jcfg, jp, prompts, tok, live):
    """JAX prefill, then one decode step with depth: (logits, depth,
    the dense cache's k and v after the step)."""
    jnp, eng = J["jnp"], J["engine"]
    cache = eng.make_cache(jcfg, prompts.shape[0], PROMPT + 4)
    _, cache = J["jax"].jit(eng.prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(prompts), cache)
    step = J["jax"].jit(eng.decode_step, static_argnums=1,
                        static_argnames="with_depth")
    logits, cache, depth = step(
        jp, jcfg, jnp.asarray(tok), cache, jnp.int32(PROMPT + 1),
        live=None if live is None else jnp.asarray(live), with_depth=True)
    return (np.asarray(logits), np.asarray(depth),
            np.asarray(cache["attn"].k), np.asarray(cache["attn"].v))


@pytest.mark.parametrize("arch,n_layers", [("llama3.2-1b", 4),
                                           ("qwen2-7b", 3),
                                           ("qwen2-moe-a2.7b", 2),
                                           ("internvl2-1b", 2)])
def test_decode_step_with_depth_matches_jax(arch, n_layers):
    """Rows halt at different layers. Each row's margin after layer k
    is read from the JAX step that halts every row after layer k
    (threshold -1, floor k + 1: its logits are the exit head's); the
    threshold sits at the middle of the widest gap between those
    margins that splits the rows' exit layers. Logits agree within
    1e-4, depth vectors exactly, and so does every layer's K/V after the
    step within 1e-4, the layers the fill wrote included; a row that is
    not live starts halted (depth 0)."""
    J = _jax()
    jcfg, jp, cfg, tp = _pair(arch, n_layers=n_layers)
    rng = np.random.default_rng(4)
    prompts = rng.integers(2, cfg.vocab, (6, PROMPT)).astype(np.int32)
    tok = rng.integers(2, cfg.vocab, (6, 1)).astype(np.int32)
    margins = []
    for k in range(n_layers):
        lg, d, _, _ = _jax_decode(J, dataclasses.replace(
            jcfg, early_exit=True, exit_threshold=-1.0,
            exit_min_layers=k + 1), jp, prompts, tok, None)
        np.testing.assert_array_equal(d, k + 1)
        top2 = np.sort(lg[:, -1].astype(np.float64), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    margins = np.stack(margins)                       # (L, B)
    s = np.sort(margins.ravel())
    best = None
    for a, b in zip(s[:-1], s[1:]):
        thr = (a + b) / 2
        exits = [int(np.argmax(np.append(m > thr, True))) for m in margins.T]
        if len(set(exits[:5])) > 1 and (best is None or b - a > best[0]):
            best = (b - a, thr, exits)
    gap, thr, exits = best
    assert gap > 1e-3                 # far from every margin
    live = np.array([True] * 5 + [False])
    over = dict(early_exit=True, exit_threshold=float(thr))
    jl, jd, jk, jv = _jax_decode(J, dataclasses.replace(jcfg, **over), jp,
                                 prompts, tok, live)
    np.testing.assert_array_equal(
        jd, [min(e + 1, n_layers) for e in exits[:5]] + [0])
    cache = engine.make_cache(cfg, 6, PROMPT + 4, device="cpu")
    engine.prefill(tp, cfg, _t(prompts), cache)
    tl, td = engine.decode_step(tp, dataclasses.replace(cfg, **over),
                                _t(tok), cache, PROMPT + 1, live=_t(live),
                                with_depth=True)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    for ours, theirs in ((cache["attn"].k, jk), (cache["attn"].v, jv)):
        np.testing.assert_allclose(ours[:, :6].numpy(), theirs, rtol=TOL,
                                   atol=TOL)


# --------------------------------------------- the toy stack, against JAX

def _toy_port(halt, live=None, n=6, B=3):
    """``decode_layers`` on a synthetic stack: an applied block adds 1
    to x (so x counts depth), a block writes +1 to its layer's leaves,
    the fill +10."""
    cfg = get_config("smollm-135m", smoke=True)
    leaves = torch.zeros((n, B))

    def block_fn(lp, x, i):
        leaves[i] += 1.0
        return x + 1.0, None

    def kv_fill_fn(lp, x, i):
        leaves[i] += 10.0

    x, depth = transformer.decode_layers(
        [{}] * n, torch.zeros((B, 1, 4)), cfg, block_fn=block_fn,
        halt_fn=halt, kv_fill_fn=kv_fill_fn,
        live=None if live is None else torch.tensor(live))
    return x[:, 0, 0].numpy(), leaves.numpy(), depth.numpy()


def _toy_jax(kind, targets, live=None, n=6):
    J = _jax()
    jnp = J["jnp"]
    B = len(targets)
    t = jnp.asarray(targets)
    cfg = J["get_config"]("smollm-135m", smoke=True)

    def block_fn(lp, lv, x, i):
        return x + 1.0, lv + 1.0, jnp.ones((B,), bool)

    def kv_fill_fn(lp, lv, x, i):
        return lv + 10.0

    x, lv, d = J["transformer"].decode_layers(
        {"w": jnp.zeros((n,))}, jnp.zeros((B, 1, 4)), jnp.zeros((n, B)), cfg,
        block_fn=block_fn, kv_fill_fn=kv_fill_fn,
        halt_fn=(lambda x, i: i == t) if kind == "pulse"
        else (lambda x, i: i >= t),
        live=None if live is None else jnp.asarray(live))
    return np.asarray(x)[:, 0, 0], np.asarray(lv), np.asarray(d)


def _host_reference(targets, live, n):
    """The adaptive loop in plain Python on the toy stack."""
    B = len(targets)
    halted = [not v for v in live]
    depth, leaves, i = np.zeros(B), np.zeros((n, B)), 0
    while i < n and not all(halted):
        for b in range(B):
            depth[b] += not halted[b]
            halted[b] = halted[b] or i >= targets[b]
        leaves[i] += 1.0
        i += 1
    leaves[i:] += 10.0
    return depth, leaves


def test_toy_halt_is_monotone_and_fill_covers_the_rest():
    """A halt that fires at one layer and goes quiet acts as a sticky
    one; depth, x and which layers the block or the fill wrote equal the
    JAX package's."""
    targets = [1, 3, 4]
    t = torch.tensor(targets)
    pulse = _toy_port(lambda x, i: i == t)
    sticky = _toy_port(lambda x, i: i >= t)
    for a, b in zip(pulse, sticky):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pulse[2], [2, 4, 5])
    np.testing.assert_array_equal(pulse[0], [2.0, 4.0, 5.0])
    np.testing.assert_array_equal(pulse[1], [[1.0] * 3] * 5 + [[10.0] * 3])
    ref = _toy_jax("pulse", targets)
    for ours, theirs in zip(pulse, ref):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(4))
def test_toy_arbitrary_exits_and_live_rows_match_jax(seed):
    """Random exit layers (past the stack too) and live masks: the port,
    the JAX package and a plain-Python model of the loop agree
    exactly; a row that is not live applies no block and extends no
    loop, but gets every layer's K/V."""
    rng = np.random.default_rng(seed)
    n, B = int(rng.integers(1, 7)), int(rng.integers(1, 5))
    targets = rng.integers(0, 9, B).tolist()
    live = rng.random(B) < 0.7
    live[0] = seed != 3               # seed 3: no row live at all
    t = torch.tensor(targets)
    x, lv, d = _toy_port(lambda x, i: i >= t, live.tolist(), n=n, B=B)
    want_d, want_lv = _host_reference(targets, live, n)
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(x, want_d)
    np.testing.assert_array_equal(lv, want_lv)
    jx, jlv, jd = _toy_jax("sticky", targets, live.tolist(), n=n)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(lv, jlv)


def test_host_lowering_reads_the_halt_vector_once_a_layer():
    """``while_loop(impl="host")`` reads ``~halted`` before each layer
    (and once more to stop); the fill's Python predicate costs no read."""
    t = torch.tensor([1, 2, 9])
    before = core.while_loop.host_reads
    _toy_port(lambda x, i: i >= t, n=6)
    assert core.while_loop.host_reads - before == 6    # 6 layers ran
    t = torch.tensor([1, 2, 2])
    before = core.while_loop.host_reads
    _toy_port(lambda x, i: i >= t, n=6)
    assert core.while_loop.host_reads - before == 4    # 3 ran, 1 stop


# ------------------------------------------- pins inside the port, exact

@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-1b",
                                  "qwen2-moe-a2.7b", "internvl2-1b"])
def test_inf_threshold_is_bit_identical(arch):
    """Threshold inf runs the halt machinery and halts nothing: the
    batch-synchronous tokens, and the scheduler's with 8 requests into 2
    slots, equal the non-adaptive engine's bit for bit, with a mean
    depth of exactly n_layers. An MoE decode routes the pool as one
    group, so its scheduler streams are held to the non-adaptive
    scheduler's (2 rows a group), not to the batch-synchronous loop's
    (8 rows)."""
    cfg, params = _model(arch)
    prompts = _prompts(cfg, n=8, seed=5)
    base = _sync(params, cfg, prompts)
    acfg = dataclasses.replace(cfg, early_exit=True)
    assert acfg.exit_threshold == float("inf")
    ada = _sync(params, acfg, prompts)
    torch.testing.assert_close(ada.tokens, base.tokens, rtol=0, atol=0)
    torch.testing.assert_close(ada.lengths, base.lengths, rtol=0, atol=0)
    ref = {r: base.tokens[r, :int(base.lengths[r])].numpy()
           for r in range(len(prompts))}
    if cfg.family == "moe":
        ref = {r: f.tokens for r, f in _through_scheduler(
            params, cfg, prompts)[1].items()}
    sched, out = _through_scheduler(params, acfg, prompts)
    for rid in range(len(prompts)):
        f = out[rid]
        np.testing.assert_array_equal(f.tokens, ref[rid])
        assert f.mean_depth == float(cfg.n_layers)
    assert sched.mean_depth == float(cfg.n_layers)
    assert sched.depth_impl == "host-read"


@pytest.mark.parametrize("kw", [{}, dict(kv="paged", kv_block=4,
                                         prefill="chunked",
                                         chunk_tokens=5)],
                         ids=["oneshot-dense", "chunked-paged"])
def test_identity_tail_exit_equals_full_and_truncated(kw):
    """Identity tail from layer 2 of 4: early exit at the layer-2 floor
    equals full depth bit for bit, every later token reading the K/V the
    fill wrote, and both equal a host-truncated 2-layer model; through
    the scheduler every request's mean depth is exactly 2."""
    cfg, params = _model(n_layers=4)
    params = _identity_tail(params, 2)
    prompts = _prompts(cfg)
    full = _sync(params, cfg, prompts)
    acfg = dataclasses.replace(cfg, early_exit=True, exit_threshold=-1.0,
                               exit_min_layers=2)
    ada = _sync(params, acfg, prompts)
    torch.testing.assert_close(ada.tokens, full.tokens, rtol=0, atol=0)
    tcfg = dataclasses.replace(cfg, n_layers=2)
    tparams = dict(params)
    tparams["layers"] = {k: (v[:2] if torch.is_tensor(v) else
                             {kk: vv[:2] for kk, vv in v.items()})
                         for k, v in params["layers"].items()}
    trunc = _sync(tparams, tcfg, prompts)
    torch.testing.assert_close(ada.tokens, trunc.tokens, rtol=0, atol=0)
    sched, out = _through_scheduler(params, acfg, prompts, **kw)
    for rid, f in out.items():
        np.testing.assert_array_equal(f.tokens,
                                      full.tokens[rid, :f.length].numpy())
        assert f.mean_depth == 2.0
    assert sched.mean_depth == 2.0


def test_scheduler_depth_stats_exact_and_reset():
    """Threshold -1 with a floor of 1 halts every row after exactly one
    block: every request's mean depth and the aggregate are exactly 1.0;
    the per-slot means too; each request counts one decode a token after
    its first; ``reset_stats`` clears them."""
    cfg, params = _model("smollm-135m")
    acfg = dataclasses.replace(cfg, early_exit=True, exit_threshold=-1.0,
                               exit_min_layers=1)
    sched = sched_lib.DecodeScheduler(
        params, acfg, n_slots=SLOTS, prompt_len=PROMPT, max_new_cap=MAX_NEW,
        eos_id=-1)
    prompts = _prompts(cfg, n=5, seed=5)
    for rid, p in enumerate(prompts):
        sched.submit(p[None, :], max_new=MAX_NEW, request_id=rid)
    done = []
    while sched.pending:
        done += sched.step()
        if sched.pending:
            assert sched.mean_depth == 1.0       # resident slots counted
    assert len(done) == len(prompts)
    assert all(f.mean_depth == 1.0 for f in done)
    assert sched.mean_depth == 1.0
    np.testing.assert_array_equal(sched.slot_mean_depth(), [1.0, 1.0])
    # a request's first token is its prefill's, and a retiring row's
    # last decode is not counted: MAX_NEW - 1 decodes a request
    assert sched.depth_layers == sched.depth_tokens == \
        len(prompts) * (MAX_NEW - 1)
    sched.reset_stats()
    assert sched.mean_depth == 0.0
    assert not sched.slot_mean_depth().any()


def test_decode_attention_runs_once_a_layer_that_ran(monkeypatch):
    """The port of ``check_depth_gating``: with every row halted after
    layer e, decode attention runs e times a step and nothing later
    attends (the fill is projection only). On the CPU the count is the
    calls of ``attention.decode_attention``; on the card, the
    paged-attention kernel's device-side launch count
    (``chip_smoke.py`` phase 23)."""
    cfg, params = _model(n_layers=4)
    prompts = _prompts(cfg)
    calls = []
    real = attention.decode_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def one_step(c):
        cache = engine.make_cache(cfg, 3, PROMPT + 2, device="cpu")
        engine.prefill(params, cfg, _t(prompts), cache)
        calls.clear()
        with monkeypatch.context() as m:
            m.setattr(attention, "decode_attention", counted)
            _, depth = engine.decode_step(params, c, _t(prompts[:, :1]),
                                          cache, PROMPT + 1, with_depth=True)
        return len(calls), depth

    assert one_step(cfg)[0] == cfg.n_layers
    for e in (1, 3):
        n, depth = one_step(dataclasses.replace(
            cfg, early_exit=True, exit_threshold=-1.0, exit_min_layers=e))
        assert n == e
        assert depth.tolist() == [e] * 3
    n, _ = one_step(dataclasses.replace(cfg, early_exit=True))
    assert n == cfg.n_layers


# ------------------------------------- the MoE and VLM families, against JAX

def test_halted_moe_rows_still_take_capacity(monkeypatch):
    """20 rows, the first 4 not live (halted from the start), threshold
    inf, under a rank-one router that sends every token to one of two
    expert pairs, so the decode group of 20 overflows its capacity of 8:
    every layer's decode routing maps equal the JAX package's.
    The halted rows are routed and hold expert slots, so live rows are
    the ones dropped, as in the JAX package, whose block runs every row
    and only masks the output."""
    J = _jax()
    jax = J["jax"]
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    jcfg, jp, cfg, _ = _pair("qwen2-moe-a2.7b", n_layers=3)
    jp = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(8)
    L, D, E = jp["layers"]["moe"]["router"].shape
    jp["layers"]["moe"]["router"] = (
        rng.standard_normal((L, D, 1)).astype(np.float32)
        * np.linspace(3, -3, E).astype(np.float32)[None, None])
    tp = bridge.from_numpy(jp, cfg, device="cpu")
    B = 20
    prompts = rng.integers(2, cfg.vocab, (B, PROMPT)).astype(np.int32)
    tok = rng.integers(2, cfg.vocab, (B, 1)).astype(np.int32)
    live = np.array([False] * 4 + [True] * 16)
    acfg, ajcfg = (dataclasses.replace(c, early_exit=True)
                   for c in (cfg, jcfg))
    jmaps, maps = [], []
    disp, route = jmoe._dispatch_gather, moe.route

    def dispatch(xg_pad, slot_token, token_slot, dropped):
        if token_slot.shape[:2] == (1, B):          # the decode regroup
            jax.debug.callback(
                lambda *a: jmaps.append([np.asarray(v) for v in a]),
                slot_token, token_slot, dropped)
        return disp(xg_pad, slot_token, token_slot, dropped)

    def rec(expert_idx, E, C):
        out = route(expert_idx, E, C)
        if expert_idx.shape[:2] == (1, B):
            maps.append([out[0].numpy(), out[2].numpy(), out[3].numpy()])
        return out

    monkeypatch.setattr(jmoe, "_dispatch_gather", dispatch)
    monkeypatch.setattr(moe, "route", rec)
    jl, jd, _, _ = _jax_decode(J, ajcfg, jp, prompts, tok, live)
    cache = engine.make_cache(cfg, B, PROMPT + 4, device="cpu")
    engine.prefill(tp, cfg, _t(prompts), cache)
    tl, td = engine.decode_step(tp, acfg, _t(tok), cache, PROMPT + 1,
                                live=_t(live), with_depth=True)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert jd.tolist() == [0] * 4 + [3] * 16
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    assert len(maps) == len(jmaps) == 3
    for ours, theirs in zip(maps, jmaps):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        dropped = ours[2][0]                         # (B, top_k)
        assert not dropped[:4].all()      # halted rows hold expert slots
        assert dropped[4:].any()          # so live rows are dropped


def _adaptive_streams(mod, params, cfg, reqs, prefix, **kw):
    sched = mod.DecodeScheduler(params, cfg, **kw)
    for rid, (p, m, pe) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid,
                     **({"prefix_embeds": pe} if prefix else {}))
    out = {f.request_id: (np.asarray(f.tokens), f.mean_depth)
           for f in sched.run_until_drained()}
    return out, sched


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-1b"])
def test_adaptive_scheduler_matches_jax_scheduler(arch):
    """Early exit after layer 2 of 3 through the chunked paged
    scheduler, 5 requests into 2 slots: every stream and each request's
    mean depth equal the JAX scheduler's. MoE prompts are exact-length
    (chunks of 5 leave a ragged last chunk); the VLM pool is built with
    ``prefix_len = n_patches`` and every request brings its patch
    embeddings, which the chunks prefill ahead of the tokens."""
    J = _jax()
    from repro.serve import scheduler as jsched
    jcfg, jp, cfg, tp = _pair(arch, n_layers=3, early_exit=True,
                              exit_threshold=-1.0, exit_min_layers=2)
    rng = np.random.default_rng(10)
    prefix = cfg.family == "vlm"
    reqs = [(rng.integers(2, cfg.vocab, (1, PROMPT)).astype(np.int32), m,
             rng.standard_normal((1, cfg.n_patches, cfg.d_model)).astype(
                 np.float32) if prefix else None)
            for m in (6, 3, 8, 4, 5)]
    kw = dict(n_slots=SLOTS, prompt_len=PROMPT, max_new_cap=MAX_NEW,
              eos_id=1, kv="paged", kv_block=4, prefill="chunked",
              chunk_tokens=5, prefix_len=cfg.n_patches if prefix else 0)
    ref, js = _adaptive_streams(jsched, jp, jcfg, reqs, prefix, **kw)
    ours, sched = _adaptive_streams(sched_lib, tp, cfg, reqs, prefix, **kw)
    assert sorted(ours) == sorted(ref) == list(range(len(reqs)))
    for rid in ref:
        np.testing.assert_array_equal(ours[rid][0], ref[rid][0])
        assert ours[rid][1] == ref[rid][1] == 2.0
    assert sched.mean_depth == 2.0
    assert sched.total_steps == js.total_steps


# --------------------------------------------------- mixture-of-depths

def test_mod_router_gradient_reaches_routed_layers_only():
    """The router weight sits in the differentiable path: routed layers
    get a non-zero gradient, the others exactly zero."""
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              n_layers=4, mod_capacity=0.5)
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    w = params["layers"]["router"]["w"]
    assert w.shape == (4, cfg.d_model) and w.dtype == torch.float32
    w.requires_grad_(True)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (2, PROMPT + 1)).astype(np.int64))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    model_zoo.loss_fn(bridge.compute_params(params, cfg), cfg,
                      batch)[0].backward()
    for i in range(cfg.n_layers):
        if adaptive.is_routed(i, cfg):
            assert w.grad[i].abs().max() > 0, f"layer {i} router starved"
        else:
            assert not w.grad[i].any()


@pytest.mark.parametrize("arch,n_layers", [("llama3.2-1b", 4),
                                           ("qwen2-moe-a2.7b", 4),
                                           ("internvl2-1b", 2)])
def test_mod_forward_features_matches_jax(arch, n_layers):
    """The full forward with routers drawn away from zero, so that the
    capacity cut keeps half of each row at the routed layers; the MoE
    aux losses too (mixture-of-depths applies on the MoE block, as in
    the JAX package's one ``block_fn``), and a VLM's patch prefix. The
    VLM runs at its smoke depth: its standard-normal patches are 50x the
    token embeddings' scale, and at 4 layers the JAX package's own fp32
    features lie 1.8e-4 from an fp64 run of the same math, past this
    test's 1e-4."""
    J = _jax()
    jcfg, jp, cfg, _ = _pair(arch, n_layers=n_layers, mod_capacity=0.5)
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((n_layers, cfg.d_model)) * 0.3).astype(
        np.float32)
    jp = {**jp, "layers": {**jp["layers"], "router": {
        "w": J["jnp"].asarray(w)}}}
    tp = bridge.from_numpy(J["jax"].tree.map(np.asarray, jp), cfg,
                           device="cpu")
    toks = rng.integers(2, cfg.vocab, (2, 11)).astype(np.int32)
    pe = (rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(
        np.float32) if cfg.family == "vlm" else None)
    ref, raux = J["jax"].jit(
        lambda p, t, e: J["transformer"].forward_features(
            p, jcfg, t, prefix_embeds=e))(
        jp, J["jnp"].asarray(toks), None if pe is None else
        J["jnp"].asarray(pe))
    ours, aux = transformer.forward_features(
        tp, cfg, _t(toks), prefix_embeds=None if pe is None else _t(pe))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert aux.keys() == raux.keys()
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]),
                                   rtol=1e-5, err_msg=k)
    # the routers' cut changed the result
    plain, _ = transformer.forward_features(
        {**tp, "layers": {**tp["layers"], "router": {
            "w": torch.zeros_like(tp["layers"]["router"]["w"])}}},
        cfg, _t(toks), prefix_embeds=None if pe is None else _t(pe))
    assert not torch.allclose(plain, ours)


@pytest.mark.parametrize("kw", [{}, dict(kv="paged", kv_block=4,
                                         prefill="chunked",
                                         chunk_tokens=5)],
                         ids=["oneshot-dense", "chunked-paged"])
def test_mod_scheduler_matches_batch_sync(kw):
    """Decode routing is the same ``mod_apply_decode`` in both loops;
    routers drawn so that the gate skips some tokens."""
    cfg, params = _model(mod_capacity=0.5, n_layers=4)
    params = dict(params)
    params["layers"] = {**params["layers"], "router": {"w": torch.from_numpy(
        (np.random.default_rng(7).standard_normal((4, cfg.d_model))
         * 0.3).astype(np.float32))}}
    prompts = _prompts(cfg, n=6, seed=5)
    sync = _sync(params, cfg, prompts)
    sched, out = _through_scheduler(params, cfg, prompts, **kw)
    for rid, f in out.items():
        np.testing.assert_array_equal(f.tokens,
                                      sync.tokens[rid, :f.length].numpy())
    assert 2.0 < sched.mean_depth < 4.0      # routed layers skipped some
    assert sched.depth_impl == "static"


def test_validate_refuses_what_cannot_work():
    base = get_config("smollm-135m", smoke=True)
    for bad, msg in ((dict(early_exit=True, exit_min_layers=0),
                      "exit_min_layers"),
                     (dict(early_exit=True, exit_min_layers=99),
                      "exit_min_layers"),
                     (dict(mod_capacity=1.5), "mod_capacity"),
                     (dict(mod_capacity=0.5, mod_every=1), "mod_every")):
        with pytest.raises(ValueError, match=msg):
            adaptive.validate(dataclasses.replace(base, **bad))
    mamba = get_config("falcon-mamba-7b", smoke=True)
    with pytest.raises(ValueError, match="attention-decoder"):
        adaptive.validate(dataclasses.replace(mamba, early_exit=True))
    cfg, params = _model("smollm-135m")
    cache = engine.make_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="live= requires"):
        engine.decode_step(params, cfg, torch.ones((1, 1), dtype=torch.long),
                           cache, 1, live=torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="exit_min_layers"):
        engine.decode_step(params, dataclasses.replace(
            cfg, early_exit=True, exit_min_layers=0),
            torch.ones((1, 1), dtype=torch.long), cache, 1)


def test_launcher_early_exit_compare_reports_depth_and_ratio(capsys):
    """``--early-exit --compare``: the depth line with the lowering, the
    early-exit-off run's mean layers beside it, and the batch-sync
    baseline with the continuous/batch-sync ratio."""
    out = launch_serve.main(
        ["--arch", "llama3.2-1b", "--smoke", "--slots", "2", "--requests",
         "4", "--prompt-len", "8", "--max-new-short", "4",
         "--max-new-long", "6", "--device", "cpu", "--early-exit",
         "--exit-threshold", "-1", "--compare"])
    text = capsys.readouterr().out
    assert "1.00 mean layers/token of 2" in text
    assert "layer loop host-read" in text
    assert "mean layers/token 1.00 | 2.00" in text
    assert "continuous/batch-sync busy tokens/s ratio" in text
    assert out["mean_depth"] == 1.0 and out["off"]["mean_depth"] == 2.0
    assert out["batch_sync"]["tokens"] == sum(
        len(s) for s in out["streams"].values())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-1b"])
def test_launcher_takes_adaptive_depth_on_moe_and_vlm(arch, capsys):
    """``--early-exit`` and ``--mod-capacity`` on the MoE and VLM
    families (the JAX launcher's flags, refused by the port before):
    threshold -1 halts every row after its first layer."""
    out = launch_serve.main(
        ["--arch", arch, "--smoke", "--slots", "2", "--requests", "3",
         "--prompt-len", "8", "--max-new-short", "3", "--max-new-long",
         "5", "--device", "cpu", "--eos-id", "-1", "--rate", "1e9",
         "--early-exit", "--exit-threshold", "-1", "--mod-capacity",
         "0.5"])
    text = capsys.readouterr().out
    assert "mod_capacity=0.5; layer loop host-read" in text
    assert out["mean_depth"] == 1.0 and out["tokens"] == 3 + 5 + 3


def test_launcher_compare_runs_the_batch_sync_baseline_alone(capsys):
    """``--compare`` with no other feature still prints the baseline."""
    out = launch_serve.main(
        ["--arch", "llama3.2-1b", "--smoke", "--slots", "2", "--requests",
         "3", "--prompt-len", "8", "--max-new-short", "3",
         "--max-new-long", "5", "--device", "cpu", "--compare"])
    text = capsys.readouterr().out
    assert "batch-sync (gather:dense" in text
    assert "continuous/batch-sync busy tokens/s ratio" in text
    assert "off" not in out and out["batch_sync"]["ratio"] > 0


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_toy_graph_lowering_equals_host_lowering_on_card(cuda_device):
    """``decode_layers`` inside a captured loop (an IF node a layer and
    one a fill layer) against the host lowering on the toy stack."""
    cfg = get_config("smollm-135m", smoke=True)
    n, B = 6, 4
    t = torch.tensor([1, 3, 4, 9], device=cuda_device)
    live = torch.tensor([True, True, True, False], device=cuda_device)
    results = {}
    for lowering in ("host", "graph"):
        leaves = torch.zeros((n, B), device=cuda_device)
        out = torch.zeros((B, 1, 4), device=cuda_device)
        depth = torch.zeros((B,), dtype=torch.int32, device=cuda_device)
        count = torch.zeros((), dtype=torch.int32, device=cuda_device)

        def block_fn(lp, x, i):
            leaves[i] += 1.0
            return x + 1.0, None

        def fill(lp, x, i):
            leaves[i] += 10.0

        def body(c):
            x, d = transformer.decode_layers(
                [{}] * n, torch.zeros_like(out), cfg, block_fn=block_fn,
                halt_fn=lambda x, i: i >= t, kv_fill_fn=fill, live=live)
            out.copy_(x)
            depth.copy_(d)
            count.add_(1)
            return c

        with torch.no_grad():
            if lowering == "host":
                body(None)
            else:
                body(None)            # eager once before the capture
                leaves.zero_()
                core.while_loop(lambda c: count < 2, body, (count,),
                                impl="graph")
        torch.cuda.synchronize()
        results[lowering] = (out[:, 0, 0].cpu(), leaves.cpu(), depth.cpu())
    for a, b in zip(results["host"], results["graph"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert results["graph"][2].tolist() == [2, 4, 5, 0]


@pytest.mark.cuda
def test_adaptive_graph_segment_equals_host_read_on_card(cuda_device):
    """The chunked paged scheduler through the kernels at threshold inf,
    at an identity tail from layer 2 of 4, and at a finite threshold:
    graph and host-read segments give the same streams and depths, and
    the device-counted paged-attention launches equal the Python-counted
    ones (2/4 of the non-adaptive run's at the identity tail)."""
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", attn_impl="cuda",
                              head_dim=64, n_heads=8, n_kv_heads=2,
                              d_model=128, n_layers=4)
    params = _identity_tail(bridge.init_params(cfg, seed=0,
                                               device=cuda_device), 2)
    prompts = _prompts(cfg, n=6, seed=5)
    variants = {"off": cfg,
                "inf": dataclasses.replace(cfg, early_exit=True),
                "tail": dataclasses.replace(cfg, early_exit=True,
                                            exit_threshold=-1.0,
                                            exit_min_layers=2)}
    runs = {}
    for name, c in variants.items():
        for loop in ("graph", "host"):
            sched = sched_lib.DecodeScheduler(
                params, c, n_slots=SLOTS, prompt_len=PROMPT,
                max_new_cap=MAX_NEW, eos_id=-1, kv="paged", kv_block=16,
                prefill="chunked", chunk_tokens=8, loop=loop)
            sched.warmup()        # its eager warm-up launches not counted
            pa_kernel.paged_attention.launches = 0
            for rid, p in enumerate(prompts):
                sched.submit(p[None, :], max_new=MAX_NEW, request_id=rid)
            out = {f.request_id: f for f in sched.run_until_drained()}
            runs[name, loop] = ({r: f.tokens for r, f in out.items()},
                                sched.mean_depth,
                                pa_kernel.paged_attention.launches,
                                sched.depth_impl)
            sched.close()
    for name in variants:
        g, h = runs[name, "graph"], runs[name, "host"]
        for r in g[0]:
            np.testing.assert_array_equal(g[0][r], h[0][r])
        assert g[1] == h[1] and g[2] == h[2] > 0
    assert runs["inf", "graph"][3] == "cuda-graph:if-per-layer"
    assert runs["inf", "graph"][1] == 4.0 and runs["tail", "graph"][1] == 2.0
    assert runs["inf", "graph"][2] == runs["off", "graph"][2]
    assert 2 * runs["tail", "graph"][2] == runs["off", "graph"][2]
    for r, toks in runs["off", "graph"][0].items():
        np.testing.assert_array_equal(runs["tail", "graph"][0][r], toks)
        np.testing.assert_array_equal(runs["inf", "graph"][0][r], toks)


@pytest.mark.cuda
def test_moe_adaptive_graph_segment_equals_host_read_on_card(cuda_device):
    """qwen2-moe's smoke width (its routing inside the captured segment)
    through the chunked paged scheduler and the kernels, under early
    exit at threshold inf and at an identity tail from layer 1 of 2:
    graph and host-read segments give the same streams, depths and
    device-counted paged-attention launches (the tail's half the
    non-adaptive run's), and inf's streams are the non-adaptive ones."""
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                              compute_dtype="float32", attn_impl="cuda",
                              head_dim=64, n_heads=4, n_kv_heads=4,
                              d_model=256)
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    lay = params["layers"] = dict(params["layers"])
    lay["attn"], lay["moe"] = dict(lay["attn"]), dict(lay["moe"])
    for tree, name in ((lay["attn"], "wo"), (lay["moe"], "w_down"),
                       (lay["moe"], "shared_down")):
        tree[name] = tree[name].clone()
        tree[name][1:] = 0
    prompts = _prompts(cfg, n=6, seed=5)
    variants = {"off": cfg,
                "inf": dataclasses.replace(cfg, early_exit=True),
                "tail": dataclasses.replace(cfg, early_exit=True,
                                            exit_threshold=-1.0,
                                            exit_min_layers=1)}
    runs = {}
    for name, c in variants.items():
        for loop in ("graph", "host"):
            sched = sched_lib.DecodeScheduler(
                params, c, n_slots=SLOTS, prompt_len=PROMPT,
                max_new_cap=MAX_NEW, eos_id=-1, kv="paged", kv_block=16,
                prefill="chunked", chunk_tokens=8, loop=loop)
            sched.warmup()
            pa_kernel.paged_attention.launches = 0
            for rid, p in enumerate(prompts):
                sched.submit(p[None, :], max_new=MAX_NEW, request_id=rid)
            out = {f.request_id: f for f in sched.run_until_drained()}
            runs[name, loop] = ({r: f.tokens for r, f in out.items()},
                                sched.mean_depth,
                                pa_kernel.paged_attention.launches)
            sched.close()
    for name in variants:
        g, h = runs[name, "graph"], runs[name, "host"]
        for r in g[0]:
            np.testing.assert_array_equal(g[0][r], h[0][r])
        assert g[1] == h[1] and g[2] == h[2] > 0
    assert runs["inf", "graph"][1] == 2.0 and runs["tail", "graph"][1] == 1.0
    assert runs["inf", "graph"][2] == runs["off", "graph"][2]
    assert 2 * runs["tail", "graph"][2] == runs["off", "graph"][2]
    for r, toks in runs["off", "graph"][0].items():
        np.testing.assert_array_equal(runs["inf", "graph"][0][r], toks)
        np.testing.assert_array_equal(runs["tail", "graph"][0][r], toks)
