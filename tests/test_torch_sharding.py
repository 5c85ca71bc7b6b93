"""Logical-axis sharding rules, meshes and the launchers of the port
against the JAX package's ``repro.dist.sharding``.

Rules are shape logic: the port's ``resolve_rules`` reads axis names and
sizes only, so it takes a bare name -> size mapping, and the JAX
package's takes a ``jax.sharding.AbstractMesh`` of the same shape; both
run in this process with no devices. For all ten configs on (2, 4)
data x model, (8,) data, (2, 2, 2) pod x data x model and (1, 1), the
rules' table, every parameter's spec (with and without the operand's
dims), its placements and ``param_axes`` are held equal field for field.

One launch of 8 gloo ranks holds each parameter's local shard on a
(2, 4) mesh to JAX's ``NamedSharding(...).shard_shape`` for every
config at smoke width, a ``constrain`` round trip to its values, the
mesh slices of disaggregation and the launcher's idempotence; a second,
of 2 ranks, shows that a rank's failure fails the launch.
"""


import jax
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jsh
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import distributed
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo

MESHES = [((2, 4), ("data", "model")), ((8,), ("data",)),
          ((2, 2, 2), ("pod", "data", "model")), ((1, 1), ("data", "model"))]
_TUPLE = {"is_leaf": lambda x: isinstance(x, tuple)}


def _jax_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, **_TUPLE)[0]}


def _paths(tree):
    return {pytree.keystr(p): v for p, v in
            pytree.tree_flatten_with_path(tree, **_TUPLE)[0]}


def _placements(spec, names):
    """The DTensor placements a JAX PartitionSpec means on a mesh."""
    where = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def test_ten_configs_on_both_packages():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_specs_and_param_axes_match_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    axes = _paths(model_zoo.param_axes(cfg))
    jaxes = _jax_paths(jzoo.param_axes(jcfg))
    assert axes == jaxes
    shapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
              jax.tree_util.tree_flatten_with_path(
                  jzoo.abstract_params(jcfg))[0]}
    for shape, names in MESHES:
        jrules = jzoo.make_rules(jcfg, AbstractMesh(shape, names))
        rules = model_zoo.make_rules(cfg, dict(zip(names, shape)))
        assert rules.table == jrules.table, (shape, names)
        for k, spec in axes.items():
            for dims in (None, shapes[k]):
                want = jrules.spec(spec, dims=dims)
                assert tuple(rules.spec(spec, dims=dims)) == tuple(want), \
                    (k, shape, dims)
            assert rules.sharding(spec) == _placements(
                jrules.spec(spec), names), (k, shape)
        placed = _paths(sh.logical_to_sharding(model_zoo.param_axes(cfg),
                                               rules))
        assert placed.keys() == axes.keys()


def test_no_mesh_rules_are_inert():
    rules = sh.resolve_rules(None, d_model=64, n_heads=4, n_kv_heads=2,
                             head_dim=16, d_ff=96, vocab=512)
    assert rules.mesh is None
    assert rules.mesh_axes(sh.BATCH) is None
    assert rules.mesh_axes(sh.MLP) is None
    x = torch.ones(2, 3)
    assert sh.constrain(x, rules, (sh.BATCH, None)) is x
    assert sh.constrain(x, None, (sh.BATCH, None)) is x
    with pytest.raises(ValueError, match="no mesh"):
        rules.sharding((sh.BATCH,))


def test_single_device_mesh_is_noop():
    rules = sh.resolve_rules({"data": 1}, d_model=64, n_heads=4,
                             n_kv_heads=2, head_dim=16, d_ff=96, vocab=512)
    assert rules.mesh_axes(sh.BATCH) is None     # size-1 axes shard nothing
    x = torch.ones(4, 8)
    assert sh.constrain(x, rules, (sh.BATCH, None)) is x


def test_spec_drops_duplicate_mesh_axes():
    table = {sh.MLP: "model", sh.VOCAB: "model"}
    rules = sh.ShardingRules(mesh={"model": 1}, table=table)
    jrules = jsh.ShardingRules(mesh=AbstractMesh((1,), ("model",)),
                               table=table)
    for spec in ((sh.MLP, sh.VOCAB), (sh.VOCAB, sh.MLP), (None, sh.MLP)):
        assert tuple(rules.spec(spec)) == tuple(jrules.spec(spec))
    assert rules.spec((sh.MLP, sh.VOCAB)) == sh.P("model", None)


def test_spec_respects_operand_divisibility():
    rules = sh.ShardingRules(mesh={"model": 4}, table={sh.MLP: "model"})
    assert rules.spec((sh.MLP,), dims=(8,)) == sh.P("model")
    assert rules.spec((sh.MLP,), dims=(6,)) == sh.P(None)
    assert rules.sharding((sh.MLP,), dims=(6,)) == (Replicate(),)


def test_scalar_spec_is_replicated():
    rules = sh.resolve_rules({"data": 1})
    assert rules.sharding(()) == (Replicate(),)
    assert rules.spec(()) == sh.P()


def test_smollm_heads_replicated_on_model_four():
    """smollm-135m at full width on (2, 4): d_ff 1536 and the padded
    vocab divide 4; its 9 heads and 3 kv heads do not."""
    rules = model_zoo.make_rules(get_config("smollm-135m"),
                                 {"data": 2, "model": 4})
    assert rules.mesh_axes(sh.BATCH) == "data"
    assert rules.mesh_axes(sh.MLP) == "model"
    assert rules.mesh_axes(sh.VOCAB) == "model"
    assert rules.mesh_axes(sh.HEADS) is None
    assert rules.mesh_axes(sh.KV_HEADS) is None
    assert rules.axis_size(sh.MLP) == 4 and rules.axis_size(sh.BATCH) == 2
    assert rules.axis_size(sh.HEADS) == 1


def test_carve_slices_and_transfer_sharding_match_jax():
    devices = list(range(8))
    for n in (1, 4, 7):
        assert sh.carve_slices(n, devices) == jsh.carve_slices(n, devices)
    for n in (0, 8):
        with pytest.raises(ValueError, match="both slices"):
            sh.carve_slices(n, devices)
        with pytest.raises(ValueError, match="both slices"):
            jsh.carve_slices(n, devices)
    dims = (2, 3, 4, 16, 2, 16)
    for shape, names in (((2, 2, 2), ("pod", "data", "model")),
                         ((4,), ("data",))):
        amesh = AbstractMesh(shape, names)
        jrules = jsh.resolve_rules(amesh, d_model=64, n_heads=4,
                                   n_kv_heads=2, head_dim=16, d_ff=96,
                                   vocab=512)
        rules = sh.resolve_rules(dict(zip(names, shape)), d_model=64,
                                 n_heads=4, n_kv_heads=2, head_dim=16,
                                 d_ff=96, vocab=512)
        want = jsh.transfer_sharding(jrules, amesh, dims).spec
        assert sh.transfer_sharding(rules, dict(zip(names, shape)),
                                    dims) == _placements(want, names)


def test_production_meshes_and_world_checks():
    assert mesh_lib.PRODUCTION_MESHES == {
        False: ((16, 16), ("data", "model")),
        True: ((2, 16, 16), ("pod", "data", "model"))}
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="the world has 1"):
            mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
    with pytest.raises(ValueError, match="rank mismatch"):
        mesh_lib.make_mesh((2, 2), ("data",), device_type="cpu")


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed(device_type="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_multi_process() is False
    with pytest.raises(ValueError, match="world_size and rank"):
        distributed.init_distributed(store=object(), device_type="cpu")


# ------------------------------------------------------- on 8 gloo ranks

def _ranks_case():
    from repro_torch import bridge
    from repro_torch.train import train_loop
    out = {"threads": torch.get_num_threads(),
           "again": distributed.init_distributed(device_type="cpu"),
           "multi": distributed.is_multi_process()}
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    shards = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        params = bridge.init_params(cfg, seed=0, device="cpu",
                                    keep_param_dtype=True)
        placed = train_loop.place_params(
            params, cfg, model_zoo.make_rules(cfg, mesh))
        shards[arch] = {k: tuple(v.to_local().shape)
                        for k, v in _paths(placed).items()}
    out["shards"] = shards

    rules = sh.resolve_rules(mesh, d_model=32, n_heads=4, n_kv_heads=4,
                             head_dim=8, d_ff=64, vocab=256)
    x = torch.randn(8, 16, 64, generator=torch.Generator().manual_seed(0))
    rep = sh.distribute_local(x, mesh, (Replicate(), Replicate()))
    y = sh.constrain(rep, rules, (sh.BATCH, None, sh.MLP))
    z = sh.constrain(sh.distribute_local(torch.ones(3, 5), mesh,
                                         (Replicate(), Replicate())),
                     rules, (sh.BATCH, None))
    out["constrain"] = (tuple(y.placements), tuple(y.to_local().shape),
                        bool(torch.equal(y.full_tensor(), x)),
                        tuple(z.placements), tuple(z.shape))

    first, rest = sh.carve_slices(4)
    m1, m2 = (sh.slice_mesh(d, device_type="cpu") for d in (first, rest))
    out["slices"] = (first, rest) + tuple(
        None if c is None else tuple(c)
        for c in (m1.get_coordinate(), m2.get_coordinate()))
    return out


def _raises_on_rank_one():
    if torch.distributed.get_rank() == 1:
        raise KeyError("rank one fails")
    torch.distributed.barrier()


@pytest.fixture(scope="module")
def ranks():
    return distributed.run_local(_ranks_case, 8, timeout=300)


def test_ranks_run_one_thread_in_one_group(ranks):
    for r in ranks:
        assert r["threads"] == 1
        assert r["again"] is True and r["multi"] is True


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shards_match_jax_shard_shapes(ranks, arch):
    jcfg = jax_get_config(arch, smoke=True)
    amesh = AbstractMesh((2, 4), ("data", "model"))
    jrules = jzoo.make_rules(jcfg, amesh)
    abstract = {jax.tree_util.keystr(p): s for p, s in
                jax.tree_util.tree_flatten_with_path(
                    jzoo.abstract_params(jcfg))[0]}
    axes = _jax_paths(jzoo.param_axes(jcfg))
    want = {k: tuple(NamedSharding(amesh, jrules.spec(axes[k])).shard_shape(
        tuple(s.shape))) for k, s in abstract.items()}
    for r in ranks:
        assert r["shards"][arch] == want


def test_constrain_round_trip_keeps_values(ranks):
    for r in ranks:
        ypl, yshape, same, zpl, zshape = r["constrain"]
        assert ypl == (Shard(0), Shard(2)) and yshape == (4, 16, 16)
        assert same
        assert zpl == (Replicate(), Replicate()) and zshape == (3, 5)


def test_slice_meshes_cover_their_ranks(ranks):
    for rank, r in enumerate(ranks):
        first, rest, c1, c2 = r["slices"]
        assert (first, rest) == ([0, 1, 2, 3], [4, 5, 6, 7])
        assert (c1, c2) == (((rank,), None) if rank < 4
                            else (None, (rank - 4,)))


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 ---(.|\n)*KeyError"):
        distributed.run_local(_raises_on_rank_one, 2, timeout=120)
