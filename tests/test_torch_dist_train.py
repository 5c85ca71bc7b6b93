"""Training on a mesh against the one-rank step, and the pipelined
gradient accumulation against the JAX package's.

One launch of 8 gloo ranks (``launch.distributed.run_local``, one torch
thread a rank) runs three cases, each rank returning what the tests
below assert on:

- one train step at smoke width on a (2, 4) data x model mesh, masters
  and AdamW moments as DTensors placed by
  ``logical_to_sharding(param_axes(cfg), rules)``, against the one-rank
  step on the same batch (computed on the rank itself);
- one step on a (2, 4) data x stage mesh with ``grad_accum=2``:
  ``accum="auto"`` (the pipeline over the stage axis) against
  ``accum="fori"``, the JAX package's ``tests/dist/test_pipeline.py``
  case;
- ``launch.train --mesh 2,4`` for three steps.

Tolerances are those of ``tests/test_torch_train.py``'s fp32 step: the
loss to 1e-5 relative, the parameters after one AdamW step to 1e-5,
except where an entry's gradient is below 1e-4 of its leaf's largest
(there the first update, about ``lr * sign(g)``, may differ by up to
``2 * lr``: the data axes' all-reduce adds the gradient in another
order). Off the mesh, ``accum="pipeline"`` with ``accum_stages`` is
held to the JAX package's pipelined step on the same weights. JAX is
imported inside the tests that use it, so that the ranks, which import
this module to find their function, start without it.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import distributed
from repro_torch.models import model_zoo
from repro_torch.optim import adamw, schedule
from repro_torch.train import train_loop

LR = 1e-3


def _smoke(**kw):
    return dataclasses.replace(get_config("smollm-135m", smoke=True),
                               compute_dtype="float32", **kw)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _step_gap(p_mesh, p_one, mu_one):
    """Per leaf: entries off the 1e-5 bound, where the gradient (its
    first moment) is not tiny."""
    bad = {}
    for (k, a), b, g in zip(pytree.tree_flatten_with_path(p_mesh)[0],
                            pytree.tree_leaves(p_one),
                            pytree.tree_leaves(mu_one)):
        tiny = g.abs() < 1e-4 * g.abs().max()
        tol = torch.where(tiny, torch.full_like(g, 2 * LR),
                          torch.full_like(g, 1e-5))
        n = int(((_full(a) - b).abs() > tol).sum())
        if n:
            bad[pytree.keystr(k)] = n
    return bad


def _ranks_case():
    """Runs on every rank of the launch."""
    from repro_torch.dist import pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from torch.distributed.tensor import DTensor
    out = {}
    opt_cfg = adamw.AdamWConfig(lr=LR, schedule=schedule.constant())

    # (2, 4) data x model against the one-rank step
    cfg = _smoke()
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    batch = SyntheticLM(cfg.vocab, 32, 8, seed=1).batch_at(0)
    p1, o1, m1 = train_loop.make_train_step(cfg, opt_cfg)(
        params, adamw.init(params), batch)
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    dp = train_loop.place_params(params, cfg, rules)
    p2, o2, m2 = train_loop.make_train_step(cfg, opt_cfg, rules)(
        dp, adamw.init(dp), batch)
    want = model_zoo.param_axes(cfg)
    out["dm"] = {
        "loss": (float(m1["loss"]), float(m2["loss"])),
        "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
        "bad": _step_gap(p2, p1, o1.mu),
        "all_dtensor": all(isinstance(t, DTensor) for t in
                           pytree.tree_leaves((p2, o2.mu, o2.nu))),
        "placed": all(
            tuple(a.placements) == tuple(b.placements) ==
            tuple(c.placements) == rules.sharding(s)
            for a, b, c, s in zip(
                pytree.tree_leaves(p2), pytree.tree_leaves(o2.mu),
                pytree.tree_leaves(o2.nu),
                pytree.tree_leaves(want,
                                   is_leaf=lambda x: isinstance(x, tuple)))),
        "w_gate": (tuple(p2["layers"]["mlp"]["w_gate"].to_local().shape),
                   str(p2["layers"]["mlp"]["w_gate"].placements)),
    }

    # (2, 4) data x stage, grad_accum=2: "auto" pipelines, equal to "fori"
    cfg = _smoke(grad_accum=2)
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    batch = SyntheticLM(cfg.vocab, 32, 16, seed=1).batch_at(0)
    mesh = mesh_lib.make_mesh((2, 4), ("data", "stage"), device_type="cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    dp = train_loop.place_params(params, cfg, rules)
    pipeline.reset_counts()
    pa, _, ma = train_loop.make_train_step(cfg, opt_cfg, rules)(
        dp, adamw.init(dp), batch)
    counts = dict(pipeline.COUNTS)
    pf, of, mf = train_loop.make_train_step(cfg, opt_cfg, rules,
                                            accum="fori")(
        dp, adamw.init(dp), batch)
    out["ds"] = {"loss": (float(ma["loss"]), float(mf["loss"])),
                 "grad_norm": (float(ma["grad_norm"]),
                               float(mf["grad_norm"])),
                 "bad": _step_gap(pa, [_full(t) for t in
                                       pytree.tree_leaves(pf)],
                                  [_full(t) for t in
                                   pytree.tree_leaves(of.mu)]),
                 "counts": counts}

    # the launcher on the (2, 4) data x model mesh
    run = launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                             "3", "--batch", "2", "--seq", "16", "--mesh",
                             "2,4", "--device", "cpu"])
    out["launcher"] = [h[1] for h in run["trainer"].history]
    return out


@pytest.fixture(scope="module")
def ranks():
    return distributed.run_local(_ranks_case, 8, timeout=300)


def test_data_model_step_equals_the_one_rank_step(ranks):
    for r in ranks:
        dm = r["dm"]
        np.testing.assert_allclose(*dm["loss"], rtol=1e-5)
        np.testing.assert_allclose(*dm["grad_norm"], rtol=1e-4)
        assert dm["bad"] == {}, dm["bad"]


def test_masters_and_moments_stay_placed_by_the_logical_axes(ranks):
    """smollm smoke on model=4: d_ff 128 and the vocab shard, its 3
    heads do not; each rank holds a quarter of w_gate's hidden dim."""
    for r in ranks:
        assert r["dm"]["all_dtensor"] and r["dm"]["placed"]
        assert r["dm"]["w_gate"] == ((2, 48, 32),
                                     "(Replicate(), Shard(dim=2))")


def test_data_stage_auto_accumulation_equals_fori(ranks):
    """grad_accum=2 microbatches over 4 stages: 2 + 4 - 1 schedule
    steps, each a ring shift; 2 live stage calls on each stage rank."""
    for r in ranks:
        ds = r["ds"]
        np.testing.assert_allclose(*ds["loss"], rtol=1e-5)
        np.testing.assert_allclose(*ds["grad_norm"], rtol=1e-4)
        assert ds["bad"] == {}, ds["bad"]
        assert ds["counts"]["steps"] == ds["counts"]["ring_shifts"] == 5
        assert ds["counts"]["stage_calls"] == 2
        assert ds["counts"]["all_reduces"] == 0


def test_launcher_trains_on_a_data_model_mesh(ranks):
    losses = ranks[0]["launcher"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(r["launcher"] == losses for r in ranks)


# ----------------------------------------------------------- off the mesh

def test_pipelined_accumulation_matches_jax():
    """accum="pipeline" with accum_stages=2 off the mesh: stage k adds
    the gradient of row-chunk k, as the JAX package's schedule does."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.data import pipeline as jpipe
    from repro.models import model_zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jschedule
    from repro.train import train_loop as jtrain
    jcfg = dataclasses.replace(jax_get_config("smollm-135m", smoke=True),
                               compute_dtype="float32", grad_accum=2)
    cfg = _smoke(grad_accum=2)
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jpipe.SyntheticLM(cfg.vocab, 32, 8, seed=1).batch_at(0)
    jopt = jadamw.AdamWConfig(lr=LR, schedule=jschedule.constant())
    jp, jo, jm = jax.jit(jtrain.make_train_step(
        jcfg, jopt, None, True, "pipeline", 2))(
        jparams, jadamw.init(jparams), batch)
    params = bridge.from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu", keep_param_dtype=True)
    p, o, m = train_loop.make_train_step(
        cfg, adamw.AdamWConfig(lr=LR, schedule=schedule.constant()),
        None, True, "pipeline", 2)(params, adamw.init(params), batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-4)
    theirs = [torch.from_numpy(np.asarray(x, np.float32))
              for x in jax.tree.leaves(jp)]
    mu = [torch.from_numpy(np.asarray(x, np.float32))
          for x in jax.tree.leaves(jo.mu)]
    assert _step_gap(p, theirs, mu) == {}


def test_make_train_step_takes_the_reference_signature():
    """(cfg, opt_cfg, rules, donate, accum, accum_stages), positionally,
    as the JAX package's: the fourth argument is ``donate``."""
    from repro.configs import get_config as jax_get_config
    from repro.optim import adamw as jadamw
    from repro.train import train_loop as jtrain
    cfg = _smoke(grad_accum=2)
    params = bridge.init_params(cfg, seed=0, device="cpu",
                                keep_param_dtype=True)
    batch = SyntheticLM(cfg.vocab, 32, 4, seed=1).batch_at(0)
    opt_cfg = adamw.AdamWConfig(lr=LR, schedule=schedule.constant())
    args = (None, False, "fori", None)
    jtrain.make_train_step(dataclasses.replace(
        jax_get_config("smollm-135m", smoke=True), grad_accum=2),
        jadamw.AdamWConfig(), *args)
    p, _, m = train_loop.make_train_step(cfg, opt_cfg, *args)(
        params, adamw.init(params), batch)
    p2, _, m2 = train_loop.make_train_step(cfg, opt_cfg, accum="fori")(
        params, adamw.init(params), batch)
    assert m["loss"].item() == m2["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(p),
                                                 pytree.tree_leaves(p2)))
