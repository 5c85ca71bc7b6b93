"""Sharded checkpoints and elastic restore: ``checkpoint.restore(...,
shardings=)``, ``save`` of DTensor leaves, ``Trainer.maybe_resume(...,
shardings=)`` and ``launch.train --mesh --ckpt-dir`` on 8 gloo CPU ranks,
held against the JAX package's checkpoints.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
case; rank 0 returns the gathered values (every rank checks its own
placements). Weights: the JAX package's draws of smollm-135m (smoke),
fp32 masters.

- A checkpoint the JAX package wrote (``repro.checkpointing.save`` of its
  parameters and AdamW state) restores onto a (4, 2) data x model port
  mesh: every leaf a DTensor over the 8 ranks, placed by the logical
  axes, its values bit-equal to the JAX arrays.
- A port checkpoint saved from a (2, 4) mesh (every rank gathers, rank 0
  writes) restores in the JAX package and onto a (4, 2) port mesh, bit
  for bit.
- ``launch.train --mesh 2,4 --ckpt-dir`` of 4 steps saves at steps 2
  and 4; with step 4's checkpoint removed (a crash after step 2), a
  fresh run resumes at 2 and trains to step 4. Onto ``--mesh 2,4`` it is
  bit-equal to the uninterrupted run. Onto ``--mesh 4,2`` it may not be:
  the two meshes add the gradients' partial sums in different orders,
  and AdamW's early updates (about ``lr * sign(g)`` where the gradient is
  small) carry a flipped sign on. The tolerance is therefore the mesh's
  own: the resumed parameters lie no farther (max |difference|) from
  the uninterrupted run's than the same 4 steps trained on (4, 2) from
  the start do. (At smoke width two steps on (4, 2) lie about 1e-4
  away and four steps about 1e-3, so a 1e-5 bar holds
  here only for the same mesh.)

JAX is imported in the parent process only.
"""

import os
import shutil

import numpy as np
import pytest
import torch.utils._pytree as pytree

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import distributed

ARGS = ["--arch", "smollm-135m", "--smoke", "--batch", "8", "--seq", "16",
        "--device", "cpu"]


def _cfg():
    return get_config("smollm-135m", smoke=True)


def _gathered(tree):
    """{key string: the whole leaf} (``jax.tree_util.keystr``'s keys, as
    the checkpoint files hold them)."""
    from repro_torch.checkpointing import checkpoint as ck
    return {k: (t.full_tensor() if hasattr(t, "full_tensor") else t)
            .numpy() for k, t in ck._items(tree)}


def _restore_on(ckpt_dir, cfg, like, shape):
    """Restore ``ckpt_dir``'s latest step onto a ``shape`` data x model
    mesh; returns (step, the state, whether every leaf is a DTensor on 8
    ranks placed by the logical axes)."""
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
    rules = model_zoo.make_rules(cfg, mesh)
    placed = sh.named_shardings(sh.logical_to_sharding(
        model_zoo.param_axes(cfg), rules), mesh)
    step, state = ck.restore_latest(
        ckpt_dir, {"params": like, "opt": adamw.init(like)},
        {"params": placed, "opt": adamw.AdamWState(step=None, mu=placed,
                                                   nu=placed)})
    want = ck._leaf_shardings(placed, like)        # key -> NamedSharding
    ok = all(sh.is_dtensor(t) and t.device_mesh.size() == 8
             and tuple(t.placements) == want[k].placements
             for tree in (state["params"], state["opt"].mu,
                          state["opt"].nu)
             for k, t in ck._items(tree))
    return step, state, ok


def _ranks_case(np_params, jax_dir, port_dir, train_dir):
    """Runs on every rank of the launch."""
    import torch.distributed as dist
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop
    cfg = _cfg()
    rank0 = dist.get_rank() == 0
    like = bridge.from_numpy(np_params, cfg, device="cpu",
                             keep_param_dtype=True)
    out = {}
    # the JAX package's checkpoint onto a (4, 2) mesh
    step, state, ok = _restore_on(jax_dir, cfg, like, (4, 2))
    out["jax"] = {"step": step, "placed": ok,
                  "params": _gathered(state["params"]),
                  "mu": _gathered(state["opt"].mu),
                  "opt_step": state["opt"].step}
    # a port checkpoint saved from a (2, 4) mesh, restored on (4, 2)
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu")
    dp = train_loop.place_params(like, cfg, model_zoo.make_rules(cfg, mesh))
    ck.save(port_dir, 3, {"params": dp, "opt": adamw.init(dp)})
    out["written"] = sorted(os.listdir(port_dir))
    step, state, ok = _restore_on(port_dir, cfg, like, (4, 2))
    out["port"] = {"step": step, "placed": ok,
                   "params": _gathered(state["params"])}
    # the launcher: an uninterrupted (2, 4) run of 4 steps checkpoints at
    # 2 and 4; with step 4's checkpoint gone (the run "crashed" after 2),
    # fresh runs resume at 2 onto (4, 2) and onto (2, 4)
    def crash_after_2():
        if rank0:
            shutil.rmtree(os.path.join(train_dir, "step_000000004"))
        dist.barrier()

    runs = {}
    train = ARGS + ["--steps", "4", "--ckpt-dir", train_dir,
                    "--ckpt-every", "2"]
    r = launch_train.main(train + ["--mesh", "2,4"])
    runs["uninterrupted"] = (r["start"], _gathered(r["params"]))
    r = launch_train.main(ARGS + ["--steps", "4", "--mesh", "4,2"])
    runs["other_mesh"] = (r["start"], _gathered(r["params"]))
    for name, shape in (("elastic", "4,2"), ("same", "2,4")):
        crash_after_2()
        r = launch_train.main(train + ["--mesh", shape])
        runs[name] = (r["start"], _gathered(r["params"]))
    out["train"] = runs
    return out if rank0 else {"jax_placed": out["jax"]["placed"],
                              "port_placed": out["port"]["placed"]}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A JAX package checkpoint, the 8-rank launch, then the JAX
    package's restore of the port's checkpoint."""
    import jax
    from repro.checkpointing import checkpoint as jck
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.optim import adamw as jadamw
    root = tmp_path_factory.mktemp("ckpt_mesh")
    dirs = [str(root / d) for d in ("jax", "port", "train")]
    jcfg = jax_get_config("smollm-135m", smoke=True)
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jadamw.init(jparams)
    # moments with values, so that the restore is not of zeros alone
    jopt = jopt._replace(mu=jax.tree.map(lambda p: p * 0.5, jparams))
    jck.save(dirs[0], 5, {"params": jparams, "opt": jopt})
    np_params = jax.tree.map(np.asarray, jparams)
    ranks = distributed.run_local(_ranks_case, 8, np_params, *dirs,
                                  timeout=400)
    step, jstate = jck.restore_latest(dirs[1], {"params": jparams,
                                                "opt": jopt})
    return {"ranks": ranks, "jparams": jparams, "jopt": jopt,
            "jax_restored": (step, jstate)}


def _jax_leaves(tree):
    """The JAX tree as ``_gathered`` keys the port's."""
    import jax
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_checkpoint_restores_onto_a_4x2_mesh(case):
    r = case["ranks"][0]["jax"]
    assert r["step"] == 5 and r["opt_step"] == 0
    assert all(x["jax_placed"] for x in case["ranks"][1:])
    assert r["placed"]
    _assert_equal(r["params"], _jax_leaves(case["jparams"]))
    _assert_equal(r["mu"], _jax_leaves(case["jopt"].mu))


def test_port_checkpoint_from_a_2x4_mesh_restores_in_jax_and_on_4x2(case):
    r = case["ranks"][0]
    assert r["written"] == ["step_000000003"]
    assert r["port"]["step"] == 3 and r["port"]["placed"]
    assert all(x["port_placed"] for x in case["ranks"][1:])
    want = _jax_leaves(case["jparams"])
    _assert_equal(r["port"]["params"], want)
    step, jstate = case["jax_restored"]
    assert step == 3
    _assert_equal(_jax_leaves(jstate["params"]), want)


def test_launcher_resumes_a_sharded_run_onto_another_mesh(case):
    runs = case["ranks"][0]["train"]
    start, elastic = runs["elastic"]
    assert start == 2
    _, same = runs["same"]
    _, ref = runs["uninterrupted"]
    assert runs["same"][0] == 2 and runs["uninterrupted"][0] == 0
    _assert_equal(same, ref)                   # the same mesh: bit-equal
    # onto another mesh: no farther from the uninterrupted run than the
    # same 4 steps trained on that mesh from the start
    _, other = runs["other_mesh"]

    def gap(a):
        return max(float(np.abs(a[k] - ref[k]).max()) for k in ref)

    assert 0 < gap(elastic) <= gap(other), (gap(elastic), gap(other))
