"""The port's LSTM, ``dynamic_rnn``, AdamW and NMT example against the
JAX package's, on the same numpy parameters and inputs:

- the plain LSTM-cell version and ``rnn.lstm_cell`` against
  ``repro.kernels.lstm_cell.ref`` and ``repro.models.rnn.lstm_cell``, and
  against the JAX Pallas kernel run in interpret mode (as
  ``tests/kernels/test_kernels.py`` runs it), fp32 and bf16;
- ``dynamic_rnn`` outputs and final state, with and without
  ``seq_lens``, and its gradients under all four save policies against
  ``jax.grad``; inside the port, dynamic == static and all policies give
  the same gradients bit for bit;
- ``adamw.apply`` against the JAX package's for 3 steps;
- three NMT training steps against the JAX example's ``model_loss`` and
  ``adamw.apply``.

Tolerances: fp32 values rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol
1e-6 (``tests/models/test_components.py``); bf16 3e-2 (rounded at
other places in the two frameworks, as the JAX kernel test allows);
optimizer and training steps rtol 1e-4, atol 1e-5 (Adam divides by
sqrt(nu), which magnifies a last-bit difference in a small gradient).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.kernels.lstm_cell import ops as jlstm_ops
from repro.kernels.lstm_cell.ref import lstm_cell_ref as jlstm_cell_ref
from repro.models import rnn as jrnn
from repro.optim import adamw as jadamw
from repro_torch import bridge, core
from repro_torch.examples import dynamic_rnn_nmt as nmt
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.models import rnn
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ["all", "offload", "carry", "carry_offload"]
KEY = jax.random.PRNGKey(0)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _close(ours, theirs, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=rtol, atol=atol)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_dynamic_rnn_nmt", ROOT / "examples" / "dynamic_rnn_nmt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lstm_params(D, H, seed=0):
    """lstm_init's tree from the JAX package, as numpy."""
    return jax.tree.map(np.asarray, jrnn.lstm_init(jax.random.PRNGKey(seed),
                                                   D, H))


# ------------------------------------------------------------------- cell

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,H", [(8, 32, 64), (5, 24, 48), (3, 72, 48)])
def test_cell_plain_versions_match_jax(dtype, B, D, H):
    rng = np.random.default_rng(B)
    arrs = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((D + H, 4 * H), 0.1), ((4 * H,), 0.1), ((B, D), 1.0),
        ((B, H), 1.0), ((B, H), 0.5))]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ours = lstm_cell_ref(*[torch.tensor(a).to(tdt) for a in arrs])
    theirs = jlstm_cell_ref(*[jnp.asarray(a, jdt) for a in arrs])
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for a, b in zip(ours, theirs):
        assert a.dtype == tdt
        _close(a, b, rtol=tol, atol=tol)
    if dtype == "float32" and B == 8:
        # the JAX Pallas kernel in interpret mode, as its tests run it
        pallas = jlstm_ops.lstm_cell(*[jnp.asarray(a) for a in arrs],
                                     blk_b=8, blk_h=H)
        for a, b in zip(lstm_ops.lstm_cell(*[torch.tensor(a) for a in arrs]),
                        pallas):
            _close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_cell_matches_jax_and_fused_cell(dtype):
    p = _lstm_params(32, 64)
    rng = np.random.default_rng(1)
    x, c, h = (rng.standard_normal(s).astype(np.float32)
               for s in ((8, 32), (8, 64), (8, 64)))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 3e-2 if dtype == "bfloat16" else 1e-6
    tp = {k: v.to(tdt) for k, v in
          bridge.lstm_params_from_numpy(p, device="cpu").items()}
    tx, tc, th = (torch.tensor(a).to(tdt) for a in (x, c, h))
    y, (c2, h2) = rnn.lstm_cell(tp, tx, (tc, th))
    jy, (jc2, jh2) = jrnn.lstm_cell(
        jax.tree.map(lambda a: jnp.asarray(a, jdt), p), jnp.asarray(x, jdt),
        (jnp.asarray(c, jdt), jnp.asarray(h, jdt)))
    for a, b in ((y, jy), (c2, jc2), (h2, jh2)):
        assert a.dtype == tdt
        _close(a, b, rtol=max(tol, 1e-5), atol=tol)
    fy, (fc, fh) = rnn.lstm_cell(tp, tx, (tc, th), kernel=lstm_ops.lstm_cell)
    for a, b in ((fy, y), (fc, c2), (fh, h2)):
        assert a.dtype == tdt
        _close(a, b, rtol=tol, atol=tol)


def test_fused_cell_refuses_autograd_on_every_device():
    """As in the JAX package, where jax.grad through the Pallas cell
    fails: the fused cell is forward-only."""
    tp = bridge.init_lstm_params(4, 8, seed=0, device="cpu")
    tp["w"].requires_grad_()
    x, s = torch.zeros(2, 4), torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="unfused"):
        lstm_ops.lstm_cell(tp["w"], tp["b"], x, s, s)
    with torch.no_grad():
        lstm_ops.lstm_cell(tp["w"], tp["b"], x, s, s)


# ------------------------------------------------------------- dynamic_rnn

def _rnn_case(B=3, S=10, D=4, H=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    lens = np.array([4, 10, 7][:B], np.int32)
    return _lstm_params(D, H, seed), x, lens


@pytest.mark.parametrize("with_lens", [False, True])
def test_dynamic_rnn_forward_matches_jax(with_lens):
    p, x, lens = _rnn_case()
    H = p["b"].shape[0] // 4
    tl = torch.tensor(lens) if with_lens else None
    jl = jnp.asarray(lens) if with_lens else None
    out, (c, h) = rnn.dynamic_rnn(bridge.lstm_params_from_numpy(p, "cpu"),
                                  torch.tensor(x), tl, hidden=H)
    jout, (jc, jh) = jrnn.dynamic_rnn(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), jl, hidden=H)
    assert out.shape == (3, 10, H)
    for a, b in ((out, jout), (c, jc), (h, jh)):
        _close(a, b)
    if with_lens:
        assert torch.count_nonzero(out[0, 4:]) == 0


@pytest.mark.parametrize("policy", POLICIES)
def test_dynamic_rnn_grads_match_jax(policy):
    p, x, lens = _rnn_case()
    H = p["b"].shape[0] // 4

    def jloss(p, x):
        out, (c, h) = jrnn.dynamic_rnn(p, x, jnp.asarray(lens), hidden=H,
                                       save_policy=policy)
        return (out ** 2).mean() + (c * h).sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    tx = torch.tensor(x, requires_grad=True)
    for t in tp.values():
        t.requires_grad_()
    out, (c, h) = rnn.dynamic_rnn(tp, tx, torch.tensor(lens), hidden=H,
                                  save_policy=policy)
    loss = (out ** 2).mean() + (c * h).sum()
    gw, gb, gx = torch.autograd.grad(loss, [tp["w"], tp["b"], tx])
    _close(loss, jloss(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    for a, b in ((gw, jg[0]["w"]), (gb, jg[0]["b"]), (gx, jg[1])):
        _close(a, b, rtol=1e-4, atol=1e-6)


def test_policies_give_identical_gradients_in_the_port():
    p, x, lens = _rnn_case(S=10)
    H = p["b"].shape[0] // 4
    grads = {}
    for policy in POLICIES:
        tp = bridge.lstm_params_from_numpy(p, "cpu")
        for t in tp.values():
            t.requires_grad_()
        out, _ = rnn.dynamic_rnn(tp, torch.tensor(x), torch.tensor(lens),
                                 hidden=H, save_policy=policy)
        grads[policy] = torch.autograd.grad((out ** 2).mean(),
                                            [tp["w"], tp["b"]])
    for policy in POLICIES:
        for a, b in zip(grads[policy], grads["all"]):
            assert torch.equal(a, b)


def test_dynamic_equals_static_and_fused_in_the_port():
    p, x, _ = _rnn_case()
    H = p["b"].shape[0] // 4
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    fused = functools.partial(rnn.lstm_cell, kernel=lstm_ops.lstm_cell)
    with torch.no_grad():
        dyn, (dc, dh) = rnn.dynamic_rnn(tp, torch.tensor(x), hidden=H)
        sta, (sc, sh) = rnn.static_rnn(tp, torch.tensor(x), hidden=H)
        fus, (fc, fh) = rnn.dynamic_rnn(tp, torch.tensor(x), hidden=H,
                                        cell=fused)
    for a, b in ((dyn, sta), (dc, sc), (dh, sh)):
        assert torch.equal(a, b)
    for a, b in ((fus, dyn), (fc, dc), (fh, dh)):
        _close(a, b, rtol=1e-6, atol=1e-6)


def test_trip_count_is_max_len_and_counts_host_reads():
    p, x, lens = _rnn_case()
    H = p["b"].shape[0] // 4
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    calls = []

    def cell(params, x_t, state):
        calls.append(1)
        return rnn.lstm_cell(params, x_t, state)

    before = core.while_loop.host_reads
    with torch.no_grad():
        rnn.dynamic_rnn(tp, torch.tensor(x), torch.tensor([2, 6, 3]),
                        hidden=H, cell=cell)
        assert len(calls) == 6
        assert core.while_loop.host_reads - before == 7   # 6 true, 1 false
        rnn.dynamic_rnn(tp, torch.tensor(x), hidden=H, cell=cell)
        assert len(calls) == 16
        assert core.while_loop.host_reads - before == 7   # counted loop


def test_multilayer_matches_jax():
    jp = jax.tree.map(np.asarray,
                      jrnn.multilayer_lstm_params(KEY, 2, 4, 8))
    x = np.random.default_rng(3).standard_normal((2, 5, 4)).astype(
        np.float32)
    out = rnn.multilayer_dynamic_rnn(bridge.lstm_params_from_numpy(jp, "cpu"),
                                     torch.tensor(x), hidden=8)
    ref = jrnn.multilayer_dynamic_rnn(jax.tree.map(jnp.asarray, jp),
                                      jnp.asarray(x), hidden=8)
    _close(out, ref)
    staged = rnn.multilayer_dynamic_rnn(
        bridge.lstm_params_from_numpy(jp, "cpu"), torch.tensor(x), hidden=8,
        stage_fn=lambda i, fn, xx: fn(xx))
    assert torch.equal(staged, out)
    gen = torch.Generator().manual_seed(0)
    shapes = [tuple(p["w"].shape) for p in
              rnn.multilayer_lstm_params(gen, 2, 4, 8)]
    assert shapes == [(12, 32), (16, 32)]


def test_init_lstm_params_rule():
    p = bridge.init_lstm_params(512, 512, seed=0, device="cpu")
    assert p["w"].shape == (1024, 2048) and torch.count_nonzero(p["b"]) == 0
    assert abs(float(p["w"].std()) - 1024 ** -0.5) < 1e-3


# ------------------------------------------------------------------- adamw

def test_adamw_matches_jax_for_three_steps():
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 2)
                          .astype(np.float32), params) for _ in range(3)]
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1.0,
                            schedule=lambda s: 1.0 / s)
    jcfg = jadamw.AdamWConfig(lr=1e-2, grad_clip=1.0,
                              schedule=lambda s: 1.0 / s)
    tp = pytree.tree_map(torch.tensor, params)
    jp = jax.tree.map(jnp.asarray, params)
    st, jst = adamw.init(tp), jadamw.init(jp)
    for g in grads:
        tp, st, m = adamw.apply(cfg, tp, pytree.tree_map(torch.tensor, g), st)
        jp, jst, jm = jadamw.apply(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                   jst)
        _close(m["grad_norm"], jm["grad_norm"])
        assert m["lr"] == pytest.approx(float(jm["lr"]))
    assert st.step == int(jst.step) == 3
    for a, b in zip(pytree.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(pytree.tree_leaves(st.nu), jax.tree.leaves(jst.nu)):
        _close(a, b, rtol=1e-4, atol=1e-7)
    axes = adamw.state_axes({"w": ("embed", "mlp")})
    assert axes.mu == {"w": ("embed", "mlp")} and axes.step == ()


# --------------------------------------------------------------------- NMT

def test_nmt_three_steps_match_jax_example():
    jex = _jax_example()
    params = jax.tree.map(np.asarray, jex.init(KEY))
    batches = [jax.tree.map(np.asarray, jex.batch(k))
               for k in jax.random.split(jax.random.PRNGKey(1), 3)]
    jcfg = jadamw.AdamWConfig(lr=jex.LR, weight_decay=0.0)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.init(jp)
    cfg = adamw.AdamWConfig(lr=nmt.LR, weight_decay=0.0)
    tp = bridge.lstm_params_from_numpy(params, "cpu")
    opt = adamw.init(tp)
    jstep = jax.jit(jax.value_and_grad(jex.model_loss))
    for src, lens, tgt in batches:
        jloss, jg = jstep(jp, src, lens, tgt)
        jp, jopt, _ = jadamw.apply(jcfg, jp, jg, jopt)
        tp, opt, loss = nmt.train_step(cfg, tp, opt, torch.tensor(src),
                                       torch.tensor(lens),
                                       torch.tensor(tgt))
        _close(loss, jloss, rtol=1e-5)
    for a, b in zip(pytree.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, rtol=1e-4, atol=1e-5)


def test_nmt_example_trains_on_cpu():
    """A shortened run of the example's entry point on the CPU: the loss
    falls well below its start (the 250-step bar runs on the card in
    chip_smoke.py)."""
    first = nmt.main(["--device", "cpu", "--steps", "1"])
    last = nmt.main(["--device", "cpu", "--steps", "40"])
    assert last < 0.5 * first
