"""The port's training path against the JAX package's: the loss and its
gradients, one train step, gradient accumulation, the in-graph loop,
the LR schedules, the data pipeline, checkpoints (both ways across the
packages), the Trainer and the launcher.

Weights are the JAX package's own draws (``bridge.from_numpy(...,
keep_param_dtype=True)``: fp32 masters), batches come from the data
pipeline. Tolerances: fp32 compute runs the same math summed in
another order, so the loss agrees to 1e-5 relative and the gradients
to 1e-4 relative (with an absolute floor of 1e-4 of the leaf's largest
gradient, for entries that are sums cancelling to near zero); after
one AdamW step the parameters agree to 1e-5 (an update is about lr
times the gradient's sign, so a gradient's relative error moves it far
less). bf16 compute rounds at other places in the two frameworks: the
loss to 1e-2 relative.
"""

import dataclasses
import os
import signal
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.checkpointing import checkpoint as jck
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import train_loop as jtrain
from repro_torch import bridge
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import MemmapCorpus, Prefetcher, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo, transformer
from repro_torch.optim import adamw, schedule
from repro_torch.train import train_loop

ARCH = "llama3.2-1b"
KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _jax_params(jcfg):
    return jzoo.init_params(jcfg, KEY)


def _ours(jparams, cfg):
    return bridge.from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", keep_param_dtype=True)


def _flat(tree):
    """{keystr: numpy array} of a port or JAX tree."""
    out = {}
    for k, v in ck._items(tree):
        out[k] = (v.detach().float().numpy() if torch.is_tensor(v)
                  else np.asarray(v, np.float32))
    return out


def _assert_trees_close(ours, theirs, rtol, atol):
    a, b = _flat(ours), _flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _batch(cfg, step=0, B=2, S=32):
    return jpipe.SyntheticLM(cfg.vocab, S, B, seed=1).batch_at(step)


def _t_batch(batch):
    return train_loop.batch_to_device(batch, "cpu")


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("layer_loop,remat,policy", [
    ("scan", "none", "all"), ("scan", "full", "all"),
    ("unroll", "none", "all"), ("unroll", "full", "all"),
    ("paper_while", "none", "all"), ("paper_while", "full", "all"),
    ("paper_while", "none", "offload"), ("scan", "dots", "all"),
    ("scan", "attn_out", "all"), ("paper_while", "attn_out", "all")])
def test_loss_and_grads_match_jax(layer_loop, remat, policy):
    jcfg, cfg = _cfgs(compute_dtype="float32", layer_loop=layer_loop,
                      remat=remat, save_policy=policy)
    jparams = _jax_params(jcfg)
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(jzoo.loss_fn, has_aux=True),
        static_argnums=1)(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    params = _ours(jparams, cfg)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_()
    loss, metrics = model_zoo.loss_fn(bridge.compute_params(params, cfg), cfg,
                                      _t_batch(batch))
    grads = torch.utils._pytree.tree_unflatten(
        list(torch.autograd.grad(loss, leaves)), spec)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert metrics["ce"] is loss
    ours_g, theirs_g = _flat(grads), _flat(jgrads)
    assert ours_g.keys() == theirs_g.keys()
    for k in ours_g:
        floor = 1e-4 * np.abs(theirs_g[k]).max()
        np.testing.assert_allclose(ours_g[k], theirs_g[k], rtol=1e-4,
                                   atol=floor, err_msg=k)


@pytest.mark.parametrize("layer_loop", ["scan", "paper_while"])
def test_attn_out_remat_gives_no_remat_gradients(layer_loop):
    """remat="attn_out" saves only the tagged attention outputs and
    recomputes the rest: the same loss and gradients as remat="none" (the
    same fp32 ops, run again), and the policy saves exactly the tag."""
    out = {}
    for remat in ("none", "attn_out"):
        _, cfg = _cfgs(compute_dtype="float32", layer_loop=layer_loop,
                       remat=remat)
        params = bridge.init_params(cfg, seed=0, device="cpu",
                                    keep_param_dtype=True)
        leaves, _ = torch.utils._pytree.tree_flatten(params)
        for p in leaves:
            p.requires_grad_()
        loss, _ = model_zoo.loss_fn(bridge.compute_params(params, cfg), cfg,
                                    _t_batch(_batch(cfg)))
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    torch.testing.assert_close(out["attn_out"][0], out["none"][0],
                               rtol=1e-6, atol=0)
    for got, ref in zip(out["attn_out"][1], out["none"][1]):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)
    policy = transformer._save_attn_out
    assert policy(None, torch.ops.repro_torch.attn_out.default) == \
        CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_cross_entropy_and_chunked_ce_match_jax():
    jcfg, cfg = _cfgs(compute_dtype="float32")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.padded_vocab)).astype(
        np.float32) * 0.1
    labels = rng.integers(-1, cfg.vocab + 3, (2, 40)).astype(np.int32)
    logits = x @ w
    np.testing.assert_allclose(
        model_zoo.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                cfg.vocab).item(),
        float(jzoo.cross_entropy(logits, labels, jcfg.vocab)), rtol=1e-5)
    np.testing.assert_allclose(
        model_zoo._chunked_ce(torch.tensor(x), torch.tensor(labels),
                              torch.tensor(w), cfg, chunk=16).item(),
        float(jzoo._chunked_ce(x, labels, w, jcfg, None, chunk=16)),
        rtol=1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_jax(arch):
    assert model_zoo.count_params(get_config(arch)) == \
        jzoo.count_params(jax_get_config(arch))


def test_masters_stay_fp32_and_cast_once():
    cfg = get_config(ARCH, smoke=True)
    masters = bridge.init_params(cfg, seed=0, device="cpu",
                                 keep_param_dtype=True)
    served = bridge.init_params(cfg, seed=0, device="cpu")
    assert all(t.dtype == torch.float32
               for t in torch.utils._pytree.tree_leaves(masters))
    cast = bridge.compute_params(masters, cfg)
    for k, v in _flat(cast).items():
        if k != "['embed']":
            torch.testing.assert_close(torch.tensor(v), torch.tensor(
                _flat(served)[k]), rtol=0, atol=0)
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    # the embedding is cast at each use (the lookup, the unembedding)
    assert cast["embed"] is masters["embed"]
    torch.testing.assert_close(cast["embed"].to(torch.bfloat16),
                               served["embed"], rtol=0, atol=0)
    assert cast["ln_final"] is masters["ln_final"]
    assert cast["layers"]["ln_attn"] is masters["layers"]["ln_attn"]


def test_tied_embedding_cotangents_meet_in_fp32():
    """bf16 compute on fp32 masters: the tied embedding's two uses (the
    lookup and the unembedding) each take their own cast, as the JAX
    package casts at each use, so their bf16 cotangents add in fp32. The
    masters' gradient equals, bit for bit, the fp32 sum of the two
    cotangents taken on separate bf16 leaves, and differs from their
    bf16 sum (what one shared cast would give)."""
    cfg = get_config(ARCH, smoke=True)
    assert cfg.tie_embeddings and cfg.dtype("compute") == torch.bfloat16
    masters = bridge.init_params(cfg, seed=0, device="cpu",
                                 keep_param_dtype=True)
    batch = _t_batch(_batch(cfg))
    embed = masters["embed"].detach().requires_grad_()
    loss, _ = model_zoo.loss_fn(
        bridge.compute_params({**masters, "embed": embed}, cfg), cfg, batch)
    (grad,) = torch.autograd.grad(loss, [embed])

    lookup = masters["embed"].to(torch.bfloat16).requires_grad_()
    unembed = masters["embed"].to(torch.bfloat16).requires_grad_()
    cast = bridge.compute_params(masters, cfg)
    x, _ = model_zoo.features({**cast, "embed": lookup}, cfg, batch)
    ce = model_zoo._chunked_ce(x, batch["labels"], unembed.T, cfg)
    g_lookup, g_unembed = torch.autograd.grad(ce, [lookup, unembed])
    assert ce.item() == loss.item()
    assert grad.dtype == torch.float32
    torch.testing.assert_close(grad, g_lookup.float() + g_unembed.float(),
                               rtol=0, atol=0)
    assert not torch.equal(grad, (g_lookup + g_unembed).float())


# --------------------------------------------------------------- train step

def test_train_step_matches_jax_fp32():
    jcfg, cfg = _cfgs(compute_dtype="float32")
    jparams = _jax_params(jcfg)
    batch = _batch(cfg)
    jopt_cfg = jadamw.AdamWConfig(schedule=jschedule.warmup_cosine(2, 10))
    jp, jo, jm = jax.jit(jtrain.make_train_step(jcfg, jopt_cfg))(
        jparams, jadamw.init(jparams), batch)
    params = _ours(jparams, cfg)
    opt_cfg = adamw.AdamWConfig(schedule=schedule.warmup_cosine(2, 10))
    p, o, m = train_loop.make_train_step(cfg, opt_cfg)(
        params, adamw.init(params), batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    _assert_trees_close(p, jp, rtol=0, atol=1e-5)
    assert o.step == int(jo.step) == 1
    _assert_trees_close(o.mu, jo.mu, rtol=1e-3, atol=1e-7)
    # the JAX state carried across goes on from the same place
    jo_t = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, jo),
                                       device="cpu")
    assert jo_t.step == 1
    _assert_trees_close(jo_t.nu, jo.nu, rtol=0, atol=0)


def test_train_step_matches_jax_bf16_with_fp32_masters():
    jcfg, cfg = _cfgs()
    assert cfg.dtype("compute") == torch.bfloat16
    jparams = _jax_params(jcfg)
    batch = _batch(cfg)
    jopt_cfg = jadamw.AdamWConfig(schedule=jschedule.constant())
    _, _, jm = jax.jit(jtrain.make_train_step(jcfg, jopt_cfg))(
        jparams, jadamw.init(jparams), batch)
    params = _ours(jparams, cfg)
    p, o, m = train_loop.make_train_step(
        cfg, adamw.AdamWConfig(schedule=schedule.constant()))(
        params, adamw.init(params), batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-2)
    assert all(t.dtype == torch.float32
               for t in torch.utils._pytree.tree_leaves((p, o.mu, o.nu)))


def test_grad_accum_equals_full_batch():
    _, cfg = _cfgs(compute_dtype="float32")
    params = bridge.init_params(cfg, seed=1, device="cpu",
                                keep_param_dtype=True)
    batch = SyntheticLM(cfg.vocab, 32, 4, seed=1).batch_at(0)
    opt_cfg = adamw.AdamWConfig(schedule=schedule.constant())
    p1, _, m1 = train_loop.make_train_step(cfg, opt_cfg)(
        params, adamw.init(params), batch)
    c2 = dataclasses.replace(cfg, grad_accum=2)
    p2, _, m2 = train_loop.make_train_step(c2, opt_cfg, accum="fori")(
        params, adamw.init(params), batch)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-6)
    _assert_trees_close(p1, p2, rtol=0, atol=1e-5)


def test_multi_device_schedules_are_refused():
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_loop.make_train_step(cfg, adamw.AdamWConfig(),
                                   accum="pipeline")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_loop.make_train_step(cfg, adamw.AdamWConfig(), mesh="4,2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_train.main(["--arch", ARCH, "--smoke", "--mesh", "2,2",
                           "--device", "cpu"])


def test_flash_path_refuses_training():
    """Under attn_impl="cuda" at a length that routes to the forward-only
    kernel, a train step stops at the kernel's refusal (the JAX package
    stops at jax.grad)."""
    _, cfg = _cfgs(attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    step = train_loop.make_train_step(cfg, adamw.AdamWConfig())
    with pytest.raises(RuntimeError, match='attn_impl="gather"'):
        step(params, adamw.init(params), _batch(cfg, S=128))


def test_in_graph_loop_equals_python_loop():
    _, cfg = _cfgs(compute_dtype="float32")
    params = bridge.init_params(cfg, seed=2, device="cpu",
                                keep_param_dtype=True)
    data = SyntheticLM(cfg.vocab, 32, 2, seed=1)
    opt_cfg = adamw.AdamWConfig(schedule=schedule.warmup_linear(1, 4))
    k = 3
    batches = {n: np.stack([data.batch_at(i)[n] for i in range(k)])
               for n in ("tokens", "labels")}
    p_in, o_in, m_in = train_loop.make_in_graph_loop(cfg, opt_cfg, k)(
        params, adamw.init(params), batches)
    step = train_loop.make_train_step(cfg, opt_cfg)
    p_py, o_py = params, adamw.init(params)
    for i in range(k):
        p_py, o_py, m_py = step(p_py, o_py, data.batch_at(i))
    _assert_trees_close(p_in, p_py, rtol=0, atol=0)
    _assert_trees_close(o_in.nu, o_py.nu, rtol=0, atol=0)
    assert o_in.step == o_py.step == k
    assert m_in["loss"].item() == m_py["loss"].item()


def test_loss_decreases():
    cfg = get_config("smollm-135m", smoke=True)
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    data = SyntheticLM(64, 32, 8, seed=1)   # small vocab: learnable fast
    step = train_loop.make_train_step(cfg, adamw.AdamWConfig(
        lr=5e-3, weight_decay=0.0, schedule=schedule.constant()))
    opt = adamw.init(params)
    losses = []
    for i in range(60):
        params, opt, m = step(params, opt, data.batch_at(i))
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, \
        (losses[:5], losses[-5:])


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (10, 100)), ("warmup_cosine", (0, 100, 0.0)),
    ("warmup_linear", (10, 100)), ("warmup_linear", (5, 50, 0.2)),
    ("constant", ())])
def test_schedules_equal_jax_at_every_step(name, args):
    """Within two float32 ulps of 1.0 (the multiplier's scale): under
    jit XLA divides by a constant through its reciprocal, contracts
    multiply-adds and has its own cos."""
    ours = getattr(schedule, name)(*args)
    theirs = jax.jit(getattr(jschedule, name)(*args))
    for step in range(101):
        np.testing.assert_allclose(ours(step),
                                   float(theirs(jnp.int32(step))),
                                   rtol=0, atol=2.4e-7, err_msg=step)


# ---------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,host,n_hosts", [(0, 0, 1), (7, 1, 2)])
def test_synthetic_lm_batches_equal_jax(seed, host, n_hosts):
    ours = SyntheticLM(500, 24, 4, seed=seed, host=host, n_hosts=n_hosts)
    theirs = jpipe.SyntheticLM(500, 24, 4, seed=seed, host=host,
                               n_hosts=n_hosts)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_memmap_corpus_equals_jax(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    ours = MemmapCorpus(str(path), 1000, 16, 4, host=1, n_hosts=2)
    theirs = jpipe.MemmapCorpus(str(path), 1000, 16, 4, host=1, n_hosts=2)
    for step in (0, 3, 200):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(ours.batch_at(step)[k],
                                          theirs.batch_at(step)[k])


def test_prefetcher_ordered_and_deterministic():
    data = SyntheticLM(100, 8, 2, seed=3)
    pf = Prefetcher(data, start_step=5)
    (s0, b0), (s1, b1) = next(pf), next(pf)
    pf.close()
    assert (s0, s1) == (5, 6)
    np.testing.assert_array_equal(b0["tokens"], data.batch_at(5)["tokens"])
    np.testing.assert_array_equal(b1["labels"], data.batch_at(6)["labels"])


# --------------------------------------------------------------- checkpoints

def _setup(lr=1e-3):
    _, cfg = _cfgs()
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    opt_cfg = adamw.AdamWConfig(lr=lr, schedule=schedule.constant())
    return (cfg, params, opt_cfg, adamw.init(params),
            SyntheticLM(cfg.vocab, 32, 4, seed=1))


def test_roundtrip_keeps_every_leaf_and_dtype(tmp_path):
    tree = {"params": {"w": torch.randn(3, 4),
                       "b": torch.randn(5).to(torch.bfloat16)},
            "opt": adamw.AdamWState(step=7, mu={"w": torch.ones(2)},
                                    nu={"w": torch.zeros(2)}),
            "list": [torch.arange(3)]}
    ck.save(str(tmp_path), 4, tree)
    like = {"params": {"w": torch.zeros(3, 4),
                       "b": torch.zeros(5, dtype=torch.bfloat16)},
            "opt": adamw.AdamWState(step=0, mu={"w": torch.zeros(2)},
                                    nu={"w": torch.ones(2)}),
            "list": [torch.zeros(3, dtype=torch.int64)]}
    step, got = ck.restore_latest(str(tmp_path), like)
    assert step == 4 and got["opt"].step == 7
    assert isinstance(got["opt"], adamw.AdamWState)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(tree)):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        ck.restore(str(tmp_path), 4, {"other": torch.zeros(1)})


def test_resume_is_exact(tmp_path):
    cfg, params, opt_cfg, opt, data = _setup()
    step = train_loop.make_train_step(cfg, opt_cfg)
    p, o = params, opt
    for i in range(3):
        p, o, _ = step(p, o, data.batch_at(i))
    ck.save(str(tmp_path), 3, {"params": p, "opt": o})
    for i in range(3, 5):
        p, o, _ = step(p, o, data.batch_at(i))
    got_step, state = ck.restore_latest(str(tmp_path),
                                        {"params": params, "opt": opt})
    assert got_step == 3 and state["opt"].step == 3
    p2, o2 = state["params"], state["opt"]
    for i in range(3, 5):
        p2, o2, _ = step(p2, o2, data.batch_at(i))
    _assert_trees_close(p2, p, rtol=0, atol=0)
    _assert_trees_close(o2.mu, o.mu, rtol=0, atol=0)


def test_atomic_commit_ignores_partial(tmp_path):
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert ck.latest_step(str(tmp_path)) is None
    ck.save(str(tmp_path), 2, {"x": torch.ones(3)})
    assert ck.latest_step(str(tmp_path)) == 2
    assert ck.latest_step(str(tmp_path / "absent")) is None


def test_keep_last_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, {"x": torch.ones(2)}, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_000000004",
                                            "step_000000005"]


def test_async_saver_snapshots_before_returning(tmp_path):
    saver = ck.AsyncSaver()
    x = torch.arange(4.0)
    saver.save_async(str(tmp_path), 1, {"x": x})
    x.add_(100.0)          # a later in-place change must not reach the file
    saver.wait()
    _, state = ck.restore_latest(str(tmp_path), {"x": torch.zeros(4)})
    torch.testing.assert_close(state["x"], torch.arange(4.0))


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """Weights and optimizer state carried across through a file, both
    ways: the same directory layout and key strings."""
    jcfg, cfg = _cfgs(compute_dtype="float32")
    jparams = _jax_params(jcfg)
    jp, jo, _ = jax.jit(jtrain.make_train_step(
        jcfg, jadamw.AdamWConfig(schedule=jschedule.constant())))(
        jparams, jadamw.init(jparams), _batch(cfg))
    jck.save(str(tmp_path / "jax"), 1, {"params": jp, "opt": jo})
    like = bridge.init_params(cfg, seed=9, device="cpu",
                              keep_param_dtype=True)
    step, state = ck.restore_latest(str(tmp_path / "jax"),
                                    {"params": like, "opt": adamw.init(like)})
    assert step == 1 and state["opt"].step == 1
    _assert_trees_close(state, {"params": jp, "opt": jo}, rtol=0, atol=0)

    ck.save(str(tmp_path / "port"), 2, state)
    jstep, jstate = jck.restore_latest(str(tmp_path / "port"),
                                       {"params": jparams,
                                        "opt": jadamw.init(jparams)})
    assert jstep == 2 and int(jstate["opt"].step) == 1
    _assert_trees_close(state, jstate, rtol=0, atol=0)


# ------------------------------------------------------------------- trainer

def test_trainer_runs_and_checkpoints(tmp_path):
    cfg, params, opt_cfg, opt, data = _setup()
    tr = train_loop.Trainer(
        train_loop.make_train_step(cfg, opt_cfg), data,
        train_loop.TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                                 log_every=100), log_fn=lambda s: None)
    p, o, m = tr.run(params, opt, steps=6)
    assert ck.latest_step(str(tmp_path)) == 5
    assert np.isfinite(float(m["loss"])) and o.step == 6
    assert [h[0] for h in tr.history] == list(range(6))


def test_watchdog_flags_the_straggler():
    """A step slower than 3x the EWMA of the earlier ones is flagged."""
    def step_fn(p, o, batch):
        time.sleep(0.25 if len(calls) == 6 else 0.01)
        calls.append(1)
        return p, o, {"loss": torch.tensor(1.0)}

    calls, logs = [], []
    tr = train_loop.Trainer(step_fn, SyntheticLM(10, 4, 1),
                            train_loop.TrainerConfig(log_every=100),
                            log_fn=logs.append)
    tr.run({}, None, steps=9)
    assert tr.straggler_steps == [6]
    assert any("[watchdog] step 6" in s for s in logs)


def test_sigterm_saves_and_exits(tmp_path):
    cfg, params, opt_cfg, opt, data = _setup()
    tr = train_loop.Trainer(
        train_loop.make_train_step(cfg, opt_cfg), data,
        train_loop.TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                                 log_every=100), log_fn=lambda s: None)
    orig, calls = tr.step_fn, {"n": 0}

    def wrapped(*a):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a)

    tr.step_fn = wrapped
    before = signal.getsignal(signal.SIGTERM)
    tr.run(params, opt, steps=100)
    assert calls["n"] == 3                   # stopped early
    assert ck.latest_step(str(tmp_path)) == 3   # saved at preemption
    assert signal.getsignal(signal.SIGTERM) is before


# ------------------------------------------------------------------ launcher

def test_launcher_runs_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    out = launch_train.main(argv + ["--steps", "2"])
    assert out["start"] == 0 and len(out["trainer"].history) == 2
    assert np.isfinite(float(out["metrics"]["loss"]))
    _, state = ck.restore_latest(str(tmp_path),
                                 {"params": out["params"], "opt": out["opt"]})
    _assert_trees_close(state["params"], out["params"], rtol=0, atol=0)
    again = launch_train.main(argv + ["--steps", "3"])
    assert again["start"] == 2 and [h[0] for h in
                                    again["trainer"].history] == [2]
    assert launch_train.main(argv + ["--steps", "2"]) is None
    assert "resumed from step 2" in capsys.readouterr().out
