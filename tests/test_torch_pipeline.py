"""The microbatch pipeline, the distributed loop and ``parallel_iterations``
against the JAX package's ``repro.dist.pipeline`` and ``repro.core``.

In this process the port's ``pipeline_loop``, ``make_pipelined_fn`` and
``distributed_while`` run off the mesh on the same numpy inputs as the
JAX package's: values to 1e-6 and gradients to 1e-5, the JAX package's
own tolerances (tests/dist/test_pipeline.py), over 1, 2 and 4
microbatches, uneven counts and the save-stack policies, with the two
rejections. ``parallel_iterations`` sets the unroll window: the host
loop takes ceil(n / window) steps and gives the results of window 1.

One launch of 8 gloo ranks runs the stage mesh (8,) (values and
gradients against the sequential chain; the ring shifts counted, as
the JAX tests look for collective-permute in the HLO), the three
heterogeneous meshes of the JAX package's regression test (a data axis
beside the stage axis must not double the activations; nothing is
all-reduced), ``distributed_while`` with and without its barrier (one
all-reduce an iteration only with it), and a loop whose DTensor carry
is offloaded to the host stack shard by shard.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import core as jcore
from repro.dist import pipeline as jpipe
from repro_torch import core
from repro_torch.dist import pipeline
from repro_torch.dist import sharding as sh
from repro_torch.launch import distributed
from repro_torch.launch import mesh as mesh_lib


def _ws(n_stages, width=8, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((width, width)) * scale).astype(np.float32)
            for _ in range(n_stages)]


def _xs(n_micro, width=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n_micro, 2, width)).astype(np.float32)


def _t_stages(ws):
    return [(lambda w: (lambda x: torch.tanh(x @ w)))(torch.tensor(w))
            for w in ws]


def _j_stages(ws):
    return [(lambda w: (lambda x: jnp.tanh(x @ w)))(jnp.asarray(w))
            for w in ws]


def _t_grad(fn, xs):
    x = torch.tensor(xs, requires_grad=True)
    y = fn(x)
    g, = torch.autograd.grad((y ** 2).sum(), x)
    return y.detach().numpy(), g.numpy()


def _j_grad(fn, xs):
    return (np.asarray(fn(jnp.asarray(xs))),
            np.asarray(jax.grad(lambda a: jnp.sum(fn(a) ** 2))(
                jnp.asarray(xs))))


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_values_and_grads_match_jax(n_micro):
    ws, xs = _ws(3), _xs(n_micro)
    y, g = _t_grad(lambda x: pipeline.pipeline_loop(
        _t_stages(ws), x, n_microbatches=n_micro), xs)
    jy, jg = _j_grad(lambda x: jpipe.pipeline_loop(_j_stages(ws), x), xs)
    np.testing.assert_allclose(y, jy, atol=1e-6)
    np.testing.assert_allclose(g, jg, atol=1e-5)


@pytest.mark.parametrize("n_micro,n_stages", [(3, 2), (5, 3), (2, 4)])
def test_uneven_microbatch_counts(n_micro, n_stages):
    """Fewer microbatches than stages, or a count that is not a
    multiple: fill and drain stay exact."""
    ws, xs = _ws(n_stages, seed=2), _xs(n_micro, seed=3)
    y, g = _t_grad(lambda x: pipeline.pipeline_loop(_t_stages(ws), x), xs)
    jy, jg = _j_grad(lambda x: jpipe.pipeline_loop(_j_stages(ws), x), xs)
    np.testing.assert_allclose(y, jy, atol=1e-6)
    np.testing.assert_allclose(g, jg, atol=1e-5)


@pytest.mark.parametrize("policy", ["offload", "carry", "carry_offload"])
def test_save_stack_policy_grads(policy):
    """The schedule's loop under each stack-saving policy against the
    JAX package's (its offload policies fall back to device stacks off
    the TPU, so "carry" is its reference for both carry policies)."""
    ws, xs = _ws(2, seed=4), _xs(4, seed=5)
    _, g = _t_grad(lambda x: pipeline.pipeline_loop(
        _t_stages(ws), x, save_policy=policy), xs)
    jpol = "carry" if policy.startswith("carry") else "all"
    _, jg = _j_grad(lambda x: jpipe.pipeline_loop(
        _j_stages(ws), x, save_policy=jpol), xs)
    np.testing.assert_allclose(g, jg, atol=1e-5)


def test_shape_changing_stage_rejected():
    with pytest.raises(ValueError, match="shape-preserving"):
        pipeline.pipeline_loop([lambda x: torch.cat([x, x], -1)],
                               torch.ones(2, 2, 4))
    with pytest.raises(ValueError):
        jpipe.pipeline_loop([lambda x: jnp.concatenate([x, x], -1)],
                            jnp.ones((2, 2, 4)))


def test_microbatch_count_mismatch_rejected():
    for mod, ones in ((pipeline, torch.ones), (jpipe, jnp.ones)):
        with pytest.raises(ValueError, match="microbatches"):
            mod.pipeline_loop([lambda x: x] * 2, ones((4, 2, 8)),
                              n_microbatches=3)


def test_make_pipelined_fn_matches_jax():
    W = np.stack(_ws(3, seed=6))
    xs = _xs(4, seed=7)
    fn = pipeline.make_pipelined_fn(lambda w, x: torch.tanh(x @ w), None)
    jfn = jpipe.make_pipelined_fn(lambda w, x: jnp.tanh(x @ w), None)
    Wt = torch.tensor(W, requires_grad=True)
    y = fn(Wt, torch.tensor(xs))
    g, = torch.autograd.grad((y ** 2).sum(), Wt)
    jy = jfn(jnp.asarray(W), jnp.asarray(xs))
    jg = jax.grad(lambda a: jnp.sum(jfn(a, jnp.asarray(xs)) ** 2))(
        jnp.asarray(W))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)


def test_schedule_steps_and_bubble():
    """M + S - 1 steps; each stage runs each microbatch once, so the
    busy share of the S x (M + S - 1) slot-steps is M / (M + S - 1)."""
    M, S = 5, 3
    pipeline.reset_counts()
    pipeline.pipeline_loop(_t_stages(_ws(S)), torch.tensor(_xs(M)))
    assert pipeline.COUNTS["steps"] == M + S - 1
    assert pipeline.COUNTS["stage_calls"] == M * S
    assert pipeline.COUNTS["ring_shifts"] == 0


@pytest.mark.parametrize("shape,names", [
    ((8,), ("stage",)), ((2, 4), ("data", "stage")), ((4, 2), ("data",
                                                              "model")),
    ((2, 2, 2), ("pod", "data", "stage"))])
def test_stage_count_and_schedule_unroll_match_jax(shape, names):
    mesh, amesh = dict(zip(names, shape)), AbstractMesh(shape, names)
    assert pipeline.stage_count(mesh) == jpipe.stage_count(amesh)
    for p in (1, 2, 4, 16):
        assert pipeline.schedule_unroll(mesh, p) == \
            jpipe.schedule_unroll(amesh, p)
    assert pipeline.stage_count(None) == jpipe.stage_count(None) == 1
    assert pipeline.stage_count(object()) == jpipe.stage_count(object())


@pytest.mark.parametrize("barrier", [False, True])
def test_distributed_while_off_mesh_matches_jax(barrier):
    x = np.linspace(0.5, 1.5, 32, dtype=np.float32).reshape(8, 4)
    y = pipeline.distributed_while(lambda v: v * 1.0001, 50, torch.tensor(x),
                                   barrier=barrier)(torch.tensor(x))
    jy = jpipe.distributed_while(lambda v: v * 1.0001, 50, jnp.asarray(x),
                                 barrier=barrier)(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6)


@pytest.mark.parametrize("window", [1, 2, 3, 4, 10])
def test_parallel_iterations_sets_the_window(window):
    """A counted loop of 10 under "all": ceil(10 / window) host steps,
    each running ``window`` bodies (the last the remainder), with the
    values and gradients of window 1 and of the JAX package's scan."""
    x0 = np.array([0.3, -0.2, 0.1], np.float32)
    W = np.random.default_rng(8).standard_normal((3, 3)).astype(np.float32)

    def run(par):
        x = torch.tensor(x0, requires_grad=True)
        before = core.while_loop.steps
        y = core.fori_loop(0, 10, lambda i, c: torch.tanh(c @ torch.tensor(W)
                                                          + i),
                           x, parallel_iterations=par)
        steps = core.while_loop.steps - before
        g, = torch.autograd.grad(y.sum(), x)
        return y.detach().numpy(), g.numpy(), steps

    y, g, steps = run(window)
    y1, g1, steps1 = run(1)
    assert steps == math.ceil(10 / window) and steps1 == 10
    np.testing.assert_array_equal(y, y1)
    np.testing.assert_array_equal(g, g1)
    jy = jcore.fori_loop(0, 10, lambda i, c: jnp.tanh(c @ W + i),
                         jnp.asarray(x0), parallel_iterations=window)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-6)


def test_parallel_iterations_under_a_stage_mesh_covers_a_rotation():
    """With mesh= and parallel_iterations > 1 the window is widened to
    the stage axis (schedule_unroll); a stack-saving policy runs rolled."""
    def steps(**kw):
        before = core.while_loop.steps
        out = core.fori_loop(0, 10, lambda i, c: c + i, torch.tensor(0.0),
                             **kw)
        assert float(out) == 45.0
        return core.while_loop.steps - before

    stage8 = {"data": 1, "stage": 8}
    assert steps(mesh=stage8, parallel_iterations=2) == 2     # window 8
    assert steps(mesh=stage8, parallel_iterations=1) == 10
    assert steps(mesh={"data": 2}, parallel_iterations=4) == 3
    with torch.enable_grad():
        x = torch.tensor(0.0, requires_grad=True)
        before = core.while_loop.steps
        core.fori_loop(0, 10, lambda i, c: c * 2, x, save_policy="carry",
                       parallel_iterations=4)
        assert core.while_loop.steps - before == 10


# ------------------------------------------------------- on 8 gloo ranks

def _sequential(W, xs):
    return core.fori_loop(0, W.shape[0],
                          lambda k, o: torch.tanh(o @ W[k]), xs)


def _stage_mesh():
    mesh = mesh_lib.make_mesh((8,), ("stage",), device_type="cpu")
    rng = np.random.default_rng(10)
    W = torch.tensor((rng.standard_normal((8, 16, 16)) * 0.3)
                     .astype(np.float32))
    xs = torch.tensor(rng.standard_normal((6, 4, 16)).astype(np.float32))
    fn = pipeline.make_pipelined_fn(lambda w, x: torch.tanh(x @ w), mesh,
                                    "stage", parallel_iterations=4)
    Wr = W.clone().requires_grad_()
    yr = _sequential(Wr, xs)
    gr, = torch.autograd.grad((yr ** 2).sum(), Wr)
    out = {}
    for kind in ("whole", "sharded"):
        pipeline.reset_counts()
        Wi = (sh.distribute_local(W, mesh, (Shard(0),)) if kind == "sharded"
              else W.clone()).requires_grad_()
        y = fn(Wi, xs)
        g, = torch.autograd.grad((y ** 2).sum(), Wi)
        g = g.full_tensor() if kind == "sharded" else g
        out[kind] = (float((y - yr).abs().max()),
                     float((g - gr).abs().max()), dict(pipeline.COUNTS))
    try:
        pipeline.pipeline_loop([torch.tanh] * 8, xs, mesh=mesh,
                               save_policy="carry")
        out["carry"] = None
    except ValueError as e:
        out["carry"] = str(e)
    return out


def _heterogeneous():
    out = []
    for n_stages, shape, axes in [(4, (2, 4), ("data", "stage")),
                                  (2, (4, 2), ("data", "stage")),
                                  (4, (2, 2, 2), ("pod", "data", "stage"))]:
        fns = _t_stages(_ws(n_stages, seed=11))
        xs = torch.tensor(np.random.default_rng(12).standard_normal(
            (6, 4, 8)).astype(np.float32))

        def chain(x):
            return functools.reduce(lambda a, f: f(a), fns, x)

        mesh = mesh_lib.make_mesh(shape, axes, device_type="cpu")
        pipeline.reset_counts()
        x = xs.clone().requires_grad_()
        y = pipeline.pipeline_loop(fns, x, mesh=mesh)
        g, = torch.autograd.grad((y ** 2).sum(), x)
        xr = xs.clone().requires_grad_()
        yr = torch.stack([chain(xr[m]) for m in range(6)])
        gr, = torch.autograd.grad((yr ** 2).sum(), xr)
        out.append((float((y - yr).abs().max()), float((g - gr).abs().max()),
                    dict(pipeline.COUNTS)))
    return out


def _distributed_while():
    mesh = mesh_lib.make_mesh((8,), ("d",), device_type="cpu")
    x = torch.ones(8, 4, 4)
    out = []
    for barrier in (False, True):
        pipeline.reset_counts()
        y = pipeline.distributed_while(lambda v: v * 1.0001, 50, x,
                                       mesh=mesh, axis="d",
                                       barrier=barrier)(x)
        out.append((tuple(y.placements), tuple(y.to_local().shape),
                    float((y.full_tensor() - x * 1.0001 ** 50).abs().max()),
                    pipeline.COUNTS["all_reduces"]))
    return out


def _offloaded_carry():
    """A loop over a carry sharded by rows, its stack offloaded: the
    host stack holds this rank's shard, the gradient is that of "all"."""
    mesh = mesh_lib.make_mesh((8,), ("data",), device_type="cpu")
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((16, 8)).astype(np.float32))
    W = torch.tensor((rng.standard_normal((8, 8)) * 0.5).astype(np.float32))
    Wd = sh.distribute_local(W, mesh, (Replicate(),))
    res = {}
    for policy in ("all", "offload", "carry_offload"):
        Wi = Wd.detach().requires_grad_()
        xd = sh.distribute_local(x, mesh, (Shard(0),))
        y = core.while_loop(None, lambda c: torch.tanh(c @ Wi), xd,
                            max_iters=3, save_policy=policy,
                            offload_shardings=(Shard(0),))
        stack = core.while_loop.last_stack
        g, = torch.autograd.grad((y ** 2).sum(), Wi)
        res[policy] = (g.full_tensor(), stack.host_bytes)
    local = x.chunk(8)[torch.distributed.get_rank()]
    local_bytes = {}
    for policy in ("offload", "carry_offload"):
        Wl = W.clone().requires_grad_()
        core.while_loop(None, lambda c: torch.tanh(c @ Wl), local,
                        max_iters=3, save_policy=policy)
        local_bytes[policy] = core.while_loop.last_stack.host_bytes
    return {"grad_gap": max(float((res[p][0] - res["all"][0]).abs().max())
                            for p in res),
            "host_bytes": {p: res[p][1] for p in res},
            "local_bytes": local_bytes}


def _ranks_case():
    return {"stage": _stage_mesh(), "hetero": _heterogeneous(),
            "while": _distributed_while(), "offload": _offloaded_carry()}


@pytest.fixture(scope="module")
def ranks():
    return distributed.run_local(_ranks_case, 8, timeout=300)


def test_stage_mesh_matches_the_sequential_chain(ranks):
    """8 stages on 8 stage ranks, 6 microbatches: 13 steps, each one
    ring shift forward and one back; stage weights held whole on every
    rank have their gradient all-reduced once, weights sharded over the
    stage axis need nothing."""
    for r in ranks:
        for kind, reduces in (("whole", 1), ("sharded", 0)):
            dy, dg, counts = r["stage"][kind]
            assert dy <= 1e-5 and dg <= 1e-5, (kind, dy, dg)
            assert counts["steps"] == counts["ring_shifts"] == 13
            assert counts["ring_shifts_grad"] == 13
            assert counts["stage_calls"] == 6
            assert counts["all_reduces"] == reduces
        assert "ring shift" in r["stage"]["carry"]


def test_heterogeneous_meshes_keep_data_axes_independent(ranks):
    """(data=2, stage=4), (data=4, stage=2), (pod, data, stage) =
    (2, 2, 2) with 4 stages on 2 stage shards: values and gradients of
    the chain (not twice them), and no collective across the data axes."""
    for r in ranks:
        for (dy, dg, counts), n_stages in zip(r["hetero"], (4, 2, 4)):
            assert dy <= 1e-6 and dg <= 1e-5, (dy, dg)
            assert counts["ring_shifts"] == 6 + n_stages - 1
            assert counts["all_reduces"] == 0


def test_distributed_while_all_reduces_once_an_iteration_with_its_barrier(
        ranks):
    for r in ranks:
        (p0, s0, e0, n0), (p1, s1, e1, n1) = r["while"]
        assert p0 == p1 == (Shard(0),) and s0 == s1 == (1, 4, 4)
        assert e0 <= 1e-5 * 1.0001 ** 50 and e1 <= 1e-5 * 1.0001 ** 50
        assert (n0, n1) == (0, 50)


def test_offloaded_dtensor_carry_keeps_local_shards(ranks):
    for r in ranks:
        off = r["offload"]
        assert off["grad_gap"] <= 1e-6
        assert off["host_bytes"]["all"] == 0
        for policy in ("offload", "carry_offload"):
            assert off["host_bytes"][policy] == off["local_bytes"][policy] \
                > 0
