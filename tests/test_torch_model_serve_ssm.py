"""Serving the SSM and hybrid families on a model axis:
``DecodeScheduler(rules=, mesh=)`` on the (2, 4) data x model mesh of 8
gloo CPU ranks, each rank on its slices of the mamba mixers and of the
SSM state, against the JAX package.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
case; the JAX package's results are made in the same module fixture.
The configs are smoke width in fp32 compute, the weights the JAX
package's draws given to the ranks as numpy arrays
(``bridge.from_numpy``), with every leaf that the JAX init draws
constant (biases, norms, ``D_skip``) given seeded noise, so that a rank
reading another rank's entries of a whole leaf shows in the streams:

- **falcon-mamba-7b** (mamba1, d_inner 128): ``INNER`` binds, so each
  rank runs 32 of the 128 channels (its x and z columns of ``in_proj``,
  the conv, ``x_proj``'s rows, ``dt_proj``, the scan through its plain
  version under ``scan_impl="cuda"``, ``out_proj``'s rows).
- **zamba2-1.2b** (mamba2, 8 heads of 16, d_state 16; the shared block
  4/4 heads, d_ff 128): each rank runs 2 of the 8 heads of every mixer
  with the whole B and C, and 1/1 head and 32 MLP columns of the shared
  block, through the paged kernel's plain version
  (``attn_impl="cuda"``).

Greedy one-shot streams equal the JAX package's one-shot scheduler's
exactly. Each rank's SSM state holds its channels (its DTensor view
split over ``model``), the K/V pool its heads, ``whole_gathers`` is 0,
and its parameter bytes are the rule-derived figure exactly. The traps
of slicing these mixers are checked on the ranks: a rank's ``in_proj``
and conv are the concatenation of their parts' slices, the gated norm
over a split width equals the one-rank norm, and a mesh that would split
a mamba2 head is refused with the rule named.
"""

import dataclasses

import numpy as np
import pytest
import torch.utils._pytree as pytree

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import distributed

MESH = (2, 4)
N_SLOTS, PROMPT, MAX_NEW = 4, 12, 6
ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
NORM_RTOL = 1e-6


def _cfg(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_impl="cuda"))
    return dataclasses.replace(cfg, attn_impl="cuda")


def _pool_kw(cfg):
    return dict(n_slots=N_SLOTS, prompt_len=PROMPT, max_new_cap=MAX_NEW,
                eos_id=1, **(dict(kv="paged", kv_block=4)
                             if cfg.family == "hybrid" else {}))


def _serve(sched, reqs):
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return {f.request_id: [int(t) for t in f.tokens]
            for f in sched.run_until_drained()}


def _placements(t):
    return tuple(repr(p) for p in t.placements)


def _norm_check(split, cfg):
    """The gated norm over a split width (``ServeSplit.rms_norm``) on the
    rank's columns against ``layers.rms_norm`` over the whole width, and
    the all-reduces it made."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.models import layers
    di = cfg.d_inner
    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.standard_normal((3, di)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(di).astype(np.float32))
    n = di // split.size
    cols = slice(split.rank * n, (split.rank + 1) * n)
    before = sh.COUNTS["split_all_reduces"]
    got = split.rms_norm(y[:, cols], w[cols], di)
    want = layers.rms_norm(y, w)[:, cols]
    err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    return err, sh.COUNTS["split_all_reduces"] - before


def _family(mesh, arch, np_params, reqs):
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_lib
    cfg = _cfg(arch)
    params = bridge.from_numpy(np_params, cfg, device="cpu")
    sh.reset_counts()
    s = sched_lib.DecodeScheduler(params, cfg,
                                  rules=model_zoo.make_rules(cfg, mesh),
                                  mesh=mesh, **_pool_kw(cfg))
    out = dict(tokens=_serve(s, reqs), layout=s.model_layout,
               counts=dict(sh.COUNTS), attn=s.attn_impl,
               held=sum(t.numel() * t.element_size()
                        for t in pytree.tree_leaves(s.params)),
               state={k: (tuple(v.shape),
                          _placements(s.sharded_pool.cache["ssm"][k]))
                      for k, v in s.pool.cache["ssm"].items()},
               mixer={k: v.numpy() for k, v in
                      s.params["layers"]["ssm"].items()})
    if cfg.family == "hybrid":
        out["kv"] = (int(s.pool.cache["attn"].k_pool.shape[3]),
                     _placements(s.sharded_pool.cache["attn"]["k_pool"]))
        out["norm"] = _norm_check(s._split, cfg)
    return out


def _refusal(mesh):
    """zamba2 with mixer heads of 64: 2 heads over a model axis of 4."""
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_lib
    cfg = _cfg("zamba2-1.2b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           head_dim=64))
    params = bridge.init_params(cfg, seed=0, device="cpu")
    try:
        sched_lib.DecodeScheduler(params, cfg,
                                  rules=model_zoo.make_rules(cfg, mesh),
                                  mesh=mesh, **_pool_kw(cfg))
    except ValueError as e:
        return str(e)
    return None


def _ranks_case(np_params, reqs):
    """Runs on every rank of the launch."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(MESH, ("data", "model"), "cpu")
    out = {arch: _family(mesh, arch, np_params[arch], reqs[arch])
           for arch in ARCHS}
    out["refusal"] = _refusal(mesh)
    out["rank"] = dist.get_rank()
    return out


def _noisy_constants(jp, seed):
    """Every leaf the JAX init draws constant (zeros, ones) plus seeded
    noise, the rest as drawn."""
    rng = np.random.default_rng(seed)
    flat, spec = pytree.tree_flatten(jp)
    flat = [a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
            if a.size > 1 and np.all(a == a.flat[0]) else a for a in flat]
    return pytree.tree_unflatten(flat, spec)


@pytest.fixture(scope="module")
def case():
    """The JAX package's streams, then the 8-rank launch."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    from repro.serve import scheduler as jsched
    init = jax.jit(jzoo.init_params, static_argnums=0)
    np_params, reqs, want = {}, {}, {}
    for seed, arch in enumerate(ARCHS):
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   compute_dtype="float32")
        jp = _noisy_constants(jax.tree.map(
            np.asarray, init(jcfg, jax.random.PRNGKey(seed))), seed)
        rng = np.random.default_rng(seed + 3)
        reqs[arch] = [(rng.integers(2, jcfg.vocab, (1, PROMPT))
                       .astype(np.int32), int(rng.integers(2, MAX_NEW + 1)))
                      for _ in range(6)]
        js = jsched.DecodeScheduler(jp, jcfg, prefill="oneshot",
                                    **_pool_kw(_cfg(arch)))
        want[arch] = _serve(js, reqs[arch])
        np_params[arch] = jp
    ranks = distributed.run_local(_ranks_case, 8, np_params, reqs,
                                  timeout=300)
    return {"want": want, "params": np_params, "ranks": ranks}


def _expected_bytes(arch, np_params):
    """A rank's parameter bytes under the rules on ``MESH``: each leaf the
    rules split over ``model`` a quarter, each part of a leaf of parts
    (``model_zoo.serve_parts``) a quarter where it splits and whole
    where it does not, every other leaf whole."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    cfg = _cfg(arch)
    m = MESH[1]
    rules = model_zoo.make_rules(cfg, {"data": MESH[0], "model": m})
    axes = {pytree.keystr(k): a for k, a in pytree.tree_flatten_with_path(
        model_zoo.param_axes(cfg),
        is_leaf=lambda a: isinstance(a, tuple))[0]}
    parts = {pytree.keystr(tuple(pytree.MappingKey(k)
                                 for k in path.split("/"))): v
             for path, v in model_zoo.serve_parts(cfg).items()}
    total = 0
    for path, a in pytree.tree_flatten_with_path(np_params)[0]:
        key = pytree.keystr(path)
        if key in parts:
            d = sh._model_dim(rules, axes[key], None)
            width = sum(w // m if split else w for w, split in parts[key])
            total += a.size // a.shape[d] * width * 4
        elif sh._model_dim(rules, axes[key], a.shape) is not None:
            total += a.size * 4 // m
        else:
            total += a.size * 4
    return total


def _parts_slice(a, parts, r, m):
    """A leaf's rank-``r`` slice, cut part by part along its last dim in
    numpy: each part that splits by a contiguous m-th, the rest whole."""
    pieces = np.split(a, np.cumsum([w for w, _ in parts])[:-1], axis=-1)
    return np.concatenate([np.split(p, m, axis=-1)[r] if split else p
                           for p, (_, split) in zip(pieces, parts)],
                          axis=-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_streams_equal_jax_on_a_model_axis(case, arch):
    """Every rank emits the JAX package's one-shot streams, on the named
    split layout, with nothing whole and the parts summed."""
    for r in case["ranks"]:
        got = r[arch]
        assert sorted(got["tokens"]) == list(range(6))
        assert got["tokens"] == case["want"][arch]
        assert got["layout"] == f"split:modelx{MESH[1]}"
        assert got["counts"]["whole_gathers"] == 0
        assert got["counts"]["split_all_reduces"] > 0
        assert got["counts"]["vocab_gathers"] > 0
    if arch == "zamba2-1.2b":
        assert case["ranks"][0][arch]["attn"] == "torch-plain-paged:cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_channels(case, arch):
    """The state holds the rank's channels (mamba1's conv and h Di/4,
    mamba2's conv Di/4 + 2N and its h H/4 heads), each DTensor view split
    over ``data`` on the slot dim and over ``model`` on the channels;
    the hybrid's K/V pool 1 of 4 heads; the parameter bytes exactly the
    rule-derived figure."""
    cfg = _cfg(arch)
    m, s, L = MESH[1], cfg.ssm, cfg.n_layers
    n, di = N_SLOTS // MESH[0], cfg.d_inner // m
    if s.kind == "mamba1":
        want = {"conv": ((L, n, s.d_conv - 1, di), 3),
                "h": ((L, n, di, s.d_state), 2)}
    else:
        want = {"conv": ((L, n, s.d_conv - 1, di + 2 * s.d_state), 3),
                "h": ((L, n, di // s.head_dim, s.head_dim, s.d_state), 2)}
    bytes_ = _expected_bytes(arch, case["params"][arch])
    for r in case["ranks"]:
        got = r[arch]
        for k, (shape, dim) in want.items():
            assert got["state"][k] == (shape, ("Shard(dim=1)",
                                               f"Shard(dim={dim})")), k
        assert got["held"] == bytes_
        if cfg.family == "hybrid":
            assert got["kv"] == (cfg.n_kv_heads // m,
                                 ("Shard(dim=1)", "Shard(dim=3)"))


@pytest.mark.parametrize("arch", ARCHS)
def test_concatenated_leaves_are_cut_part_by_part(case, arch):
    """A rank's ``in_proj`` (and mamba2's conv) is the concatenation of
    its parts' slices: x and z (mamba1); z, x, the whole B and C, and dt
    (mamba2) — not a contiguous quarter of the whole."""
    cfg = _cfg(arch)
    m, di, N = MESH[1], cfg.d_inner, cfg.ssm.d_state
    whole = case["params"][arch]["layers"]["ssm"]
    if cfg.ssm.kind == "mamba1":
        leaves = {"in_proj": ((di, True), (di, True))}
    else:
        xbc = ((di, True), (N, False), (N, False))
        leaves = {"in_proj": ((di, True),) + xbc
                  + ((di // cfg.ssm.head_dim, True),),
                  "conv_w": xbc, "conv_b": xbc}
    for r in case["ranks"]:
        coord = r["rank"] % m
        for name, parts in leaves.items():
            got = r[arch]["mixer"][name]
            np.testing.assert_array_equal(
                got, _parts_slice(whole[name], parts, coord, m), name)
            assert not np.array_equal(
                got, np.split(whole[name], m, axis=-1)[coord]), name


def test_gated_norm_over_a_split_width(case):
    """mamba2's norm on a rank's 32 of 128 columns: one all-reduce of the
    sums of squares, equal to the one-rank norm to 1e-6 relative."""
    for r in case["ranks"]:
        err, reduces = r["zamba2-1.2b"]["norm"]
        assert err <= NORM_RTOL and reduces == 1


def test_a_mesh_that_splits_a_head_is_refused(case):
    """Mixer heads of 64 give 2 heads, which a model axis of 4 cannot
    split whole: every rank refuses at construction and names the
    rule."""
    for r in case["ranks"]:
        msg = r["refusal"]
        assert msg is not None
        assert "layers/ssm/in_proj" in msg and "split a head" in msg
        assert "'inner'" in msg and "'model'" in msg
