"""The model axis in the training step: expert-parallel MoE and the
vocab-parallel chunked cross entropy on gloo CPU ranks, against the JAX
package.

One launch of 8 gloo ranks (``launch.distributed.run_local``) runs every
case, on a (2, 4) and a (4, 2) data x model mesh of all 8 ranks. The
configs are smoke width in fp32 compute, B=8, S=8:

- dbrx-132b (4 experts): ``EXPERT`` binds to ``model`` on both meshes,
  so each rank holds E/m experts' rows;
- qwen2-moe-a2.7b (6 experts, expert hidden width 48): ``EXPERT_MLP``
  on (2, 4) (6 experts do not split 4 ways; each rank holds 12 of every
  expert's 48 hidden columns) and ``EXPERT`` on (4, 2);
- llama3.2-1b and whisper-small: the vocab-parallel CE through a tied
  embedding (the MoE configs' unembedding is untied); every config's
  padded vocab of 512 splits over the model axis.

Each mesh step's loss and every leaf's gradient
(``train_loop.loss_and_grads``) are held to the JAX package's
``model_zoo.loss_fn`` and ``jax.grad`` on the same weights: loss within
1e-5 relative, each gradient within 1e-4 of its leaf's largest entry.
The gate that the weights stay split is the shape each rank's function
sees: the expert weight inside the expert computation
(``moe.expert_swiglu``) must have E/m rows or F/m hidden columns, and
the unembedding inside the CE (``model_zoo._VocabParallelNLL``) Vp/m
columns. ``sharding.COUNTS["whole_gathers"]``, the weights handed to
those functions whole, must read 0 on every rank; a replicated
unembedding on the same meshes reads 1 there.

The weights are the JAX package's draws given to the ranks as numpy
arrays (``bridge.from_numpy``), except whisper-small's, which are the
port's draws given to the JAX package, as in ``tests/test_torch_train.py``
(the JAX draws' near-argmax attention puts the two packages' fp32
gradients up to 2e-4 of a leaf's largest apart on one device already).
JAX is imported in the parent only. A CPU unit test of the vocab-parallel
CE, on masked labels and a padded vocab, runs in the same launch, with
the columns split and with them whole.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import sharding as sh
from repro_torch.launch import distributed
from repro_torch.models import model_zoo

MESHES = ((2, 4), (4, 2))
ARCHS = ("dbrx-132b", "qwen2-moe-a2.7b", "llama3.2-1b", "whisper-small")
B, S = 8, 8
# the CE unit case: a vocab of 21 padded to 24 columns (6 a rank on 4),
# labels masked below 0 and at or past 21 (the padded columns among them)
CE_VOCAB, CE_PADDED, CE_D, CE_CHUNK = 21, 24, 8, 5
CE_LABELS = np.array([[3, -1, 20, 21, 5, 23, 0, 7, 100, 11, 2],
                      [22, 6, 6, -5, 19, 1, 12, 13, 8, 4, 9],
                      [0, 23, 17, 17, 16, -1, 14, 2, 3, 20, 18],
                      [10, 9, 21, 22, 23, 5, 4, 3, 2, 1, 15]], np.int64)


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32")


def _batch(cfg):
    return SyntheticLM(cfg.vocab, S, B, seed=1,
                       frames=((cfg.n_frames, cfg.d_model)
                               if cfg.family == "audio" else None)
                       ).batch_at(0)


def _flat(tree):
    return {pytree.keystr(k): v for k, v in
            pytree.tree_flatten_with_path(tree)[0]}


def _ce_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, CE_LABELS.shape[1], CE_D)).astype(np.float32)
    w = rng.standard_normal((CE_D, CE_PADDED)).astype(np.float32)
    return x, w


def _ce_cfg():
    return dataclasses.replace(_cfg("llama3.2-1b"), vocab=CE_VOCAB)


def _ce_mesh_case(mesh, split=True):
    """The chunked CE of ``_ce_inputs`` with its rows split over data and
    its 24 columns over model (``split``) or whole: (loss, dx, dw, the
    local w shapes seen)."""
    from torch.distributed.tensor import Replicate, Shard
    x, w = (torch.from_numpy(a) for a in _ce_inputs())
    labels = torch.from_numpy(CE_LABELS)
    dx = sh.distribute_local(x, mesh, [Shard(0), Replicate()])
    dw = sh.distribute_local(w, mesh, [Replicate(),
                                       Shard(1) if split else Replicate()])
    dl = sh.distribute_local(labels, mesh, [Shard(0), Replicate()])
    dx.requires_grad_()
    dw.requires_grad_()
    seen = set()
    with _recording(seen=seen):
        loss = model_zoo._chunked_ce(dx, dl, dw, _ce_cfg(), chunk=CE_CHUNK)
        gx, gw = torch.autograd.grad(loss.full_tensor(), (dx, dw))
    return (float(loss.full_tensor()), gx.full_tensor().numpy(),
            gw.full_tensor().numpy(), sorted(seen))


class _recording:
    """Records the shape of ``w_gate`` inside ``moe.expert_swiglu`` and
    of the unembedding inside ``model_zoo._VocabParallelNLL``."""

    def __init__(self, experts=None, seen=None):
        self.experts, self.seen = experts, seen

    def __enter__(self):
        from repro_torch.models import moe
        self.saved = moe.expert_swiglu, model_zoo._VocabParallelNLL
        plain_swiglu, plain_nll = self.saved
        experts, seen = self.experts, self.seen

        def swiglu(be, w_gate, *rest):
            if experts is not None:
                experts.add(tuple(w_gate.shape))
            return plain_swiglu(be, w_gate, *rest)

        class Recorded(plain_nll):
            @staticmethod
            def forward(ctx, x, labels, w, *rest):
                if seen is not None:
                    seen.add(tuple(w.shape))
                return plain_nll.forward(ctx, x, labels, w, *rest)

        moe.expert_swiglu, model_zoo._VocabParallelNLL = swiglu, Recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.expert_swiglu, model_zoo._VocabParallelNLL = self.saved


def _ranks_case(np_params, want):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import train_loop
    out = {}
    for shape in MESHES:
        mesh = mesh_lib.make_mesh(shape, ("data", "model"),
                                  device_type="cpu")
        for arch in ARCHS:
            cfg = _cfg(arch)
            rules = model_zoo.make_rules(cfg, mesh)
            params = bridge.from_numpy(np_params[arch], cfg, device="cpu",
                                       keep_param_dtype=True)
            placed = train_loop.place_params(params, cfg, rules)
            batch = train_loop.batch_to_device(_batch(cfg), "cpu")
            experts, seen = set(), set()
            sh.reset_counts()
            with _recording(experts, seen):
                loss, _, grads = train_loop.loss_and_grads(placed, cfg, batch,
                                                           rules)
            counts = dict(sh.COUNTS)
            jloss, jgrads = want[arch]
            gap = {}
            for k, g in _flat(grads).items():
                ref = jgrads[k]
                err = float(np.abs(g.full_tensor().numpy() - ref).max())
                gap[k] = err / max(float(np.abs(ref).max()), 1e-30)
            out[(shape, arch)] = dict(
                loss=float(loss), jloss=jloss, gap=gap, counts=counts,
                experts=sorted(experts), seen=sorted(seen),
                routes={a: rules.mesh_axes(a) for a in (
                    sh.EXPERT, sh.EXPERT_MLP, sh.VOCAB)})
        for split in (True, False):
            sh.reset_counts()
            out[(shape, "ce", split)] = _ce_mesh_case(mesh, split) + (
                dict(sh.COUNTS),)
    return out


@pytest.fixture(scope="module")
def case():
    """JAX's loss and gradients for each config, then the one launch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    np_params, want = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   compute_dtype="float32")
        if cfg.family == "audio":
            params = bridge.init_params(cfg, seed=0, device="cpu",
                                        keep_param_dtype=True)
            np_params[arch] = pytree.tree_map(lambda t: t.numpy(), params)
        else:
            np_params[arch] = jax.tree.map(
                np.asarray, jzoo.init_params(jcfg, jax.random.PRNGKey(0)))
        (loss, _), grads = jax.jit(
            jax.value_and_grad(jzoo.loss_fn, has_aux=True),
            static_argnums=1)(jax.tree.map(jnp.asarray, np_params[arch]),
                              jcfg, jax.tree.map(jnp.asarray, _batch(cfg)))
        want[arch] = (float(loss), {k: np.asarray(v, np.float32) for k, v in
                                    _flat(jax.tree.map(np.asarray,
                                                       grads)).items()})
    x, w = _ce_inputs()

    def ce(x, w):
        return jzoo.cross_entropy(x @ w, jnp.asarray(CE_LABELS), CE_VOCAB)

    ce_loss, (ce_dx, ce_dw) = jax.value_and_grad(ce, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    # the launch takes about 30 s alone; the bound is a hang guard for a
    # loaded machine (three to five times slower under the full suite)
    ranks = distributed.run_local(_ranks_case, 8, np_params, want,
                                  timeout=600)
    return {"ranks": ranks, "ce": (float(ce_loss), np.asarray(ce_dx),
                                   np.asarray(ce_dw))}


def _route(shape, arch):
    """The binding each case must take on ``shape``."""
    if arch == "dbrx-132b" or (arch == "qwen2-moe-a2.7b" and shape[1] == 2):
        return sh.EXPERT
    return sh.EXPERT_MLP if arch == "qwen2-moe-a2.7b" else None


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_meets_jax_with_no_whole_gather(case, shape, arch):
    cfg = _cfg(arch)
    for r in case["ranks"]:
        got = r[(shape, arch)]
        np.testing.assert_allclose(got["loss"], got["jloss"], rtol=1e-5)
        off = {k: v for k, v in got["gap"].items() if not v <= 1e-4}
        assert off == {}, off
        assert got["counts"]["whole_gathers"] == 0, got["counts"]
        assert got["counts"]["whole_gather_bytes"] == 0, got["counts"]
        assert got["counts"]["split_all_reduces"] > 0, got["counts"]
        assert got["routes"][sh.VOCAB] == "model"
        assert got["seen"] == [(cfg.d_model, cfg.padded_vocab // shape[1])]
        route = _route(shape, arch)
        if route is None:
            assert got["experts"] == []
            continue
        m = cfg.moe
        assert got["routes"][route] == "model"
        assert got["routes"][({sh.EXPERT, sh.EXPERT_MLP} - {route}).pop()] \
            is None
        want = ((m.n_experts // shape[1], cfg.d_model, m.d_ff_expert)
                if route == sh.EXPERT else
                (m.n_experts, cfg.d_model, m.d_ff_expert // shape[1]))
        assert got["experts"] == [want]


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "4x2"])
def test_vocab_parallel_ce_masked_labels_padded_vocab(case, shape):
    """The chunked CE over 24 padded columns split over the model axis
    (chunks of 5 over 11 positions, so the last is padded), labels masked
    below 0, in the padded columns and past them: the loss and both
    gradients against the JAX package's ``cross_entropy``."""
    loss, dx, dw = case["ce"]
    for r in case["ranks"]:
        got_loss, got_dx, got_dw, seen, counts = r[(shape, "ce", True)]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(got_dx, dx, rtol=0,
                                   atol=1e-5 * np.abs(dx).max())
        np.testing.assert_allclose(got_dw, dw, rtol=0,
                                   atol=1e-5 * np.abs(dw).max())
        assert seen == [(CE_D, CE_PADDED // shape[1])]
        assert counts["whole_gathers"] == 0


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "4x2"])
def test_a_whole_unembedding_is_counted(case, shape):
    """The same CE with the unembedding replicated over the model axis:
    the plain per-chunk CE on each rank's rows (``_VocabParallelNLL``
    never runs), the same loss and gradients, and the one weight handed
    to it whole counted with its bytes."""
    loss, dx, dw = case["ce"]
    for r in case["ranks"]:
        got_loss, got_dx, got_dw, seen, counts = r[(shape, "ce", False)]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(got_dx, dx, rtol=0,
                                   atol=1e-5 * np.abs(dx).max())
        np.testing.assert_allclose(got_dw, dw, rtol=0,
                                   atol=1e-5 * np.abs(dw).max())
        assert seen == []
        assert counts["whole_gathers"] == 1
        assert counts["whole_gather_bytes"] == CE_D * CE_PADDED * 4
        assert counts["split_all_reduces"] == 0


def test_vocab_parallel_nll_without_a_split_equals_the_plain_ce():
    """The arithmetic of ``_VocabParallelNLL``'s custom backward on one
    rank: with no split (all columns, no collective; the model itself
    takes ``_token_nll`` there), masked labels and a padded vocab, the
    loss and its gradients against autograd through
    ``model_zoo._token_nll``. The mesh cases above hold the split path to
    the JAX package."""
    x, w = (torch.from_numpy(a).requires_grad_() for a in _ce_inputs())
    labels = torch.from_numpy(CE_LABELS)
    s, c = model_zoo._VocabParallelNLL.apply(x, labels, w, 0, CE_VOCAB,
                                             sh.NO_SPLIT)
    gx, gw = torch.autograd.grad(s / c, (x, w))
    per_tok, valid = model_zoo._token_nll(x @ w, labels, CE_VOCAB)
    ref = per_tok.sum() / valid.sum()
    rx, rw = torch.autograd.grad(ref, (x, w))
    assert int(c) == int(((CE_LABELS >= 0) & (CE_LABELS < CE_VOCAB)).sum())
    torch.testing.assert_close(s / c, ref, rtol=1e-6, atol=0)
    torch.testing.assert_close(gx, rx, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gw, rw, rtol=1e-6, atol=1e-7)
