"""Every family's train step on a (2, 4) data x model mesh of 8 gloo
ranks against the one-rank step.

The model code is single-device code on every family; on a mesh the
masters are DTensors placed by their logical axes and DTensor's
propagation places the activations, with the chunked attention on each
rank's rows and heads, the MoE routing and experts on its rows and its
slice of the experts, and the chunked cross entropy on its rows and its
columns of the unembedding (``dist.sharding.local_heads``,
``split_rows``, ``split_mean``). One launch runs one fp32 step of each
family at smoke width (B=8, S=8, with a VLM's patches and the audio
family's frames) on the mesh and on the rank alone. Eight rows leave
four on a data rank. The loss is held to 1e-5 relative, the gradient
norm to 1e-4, and every updated parameter to 1e-5, except where an
entry's gradient is below 1e-4 of its leaf's largest (there the first
update, about ``lr * sign(g)``, may differ by up to ``2 * lr``), as in
``tests/test_torch_train.py``'s fp32 step.
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

# one config a family (the dense one with GQA, whose K/V heads do not
# divide the model axis while its query heads do)
FAMILIES = ["llama3.2-1b", "qwen2-moe-a2.7b", "internvl2-1b",
            "falcon-mamba-7b", "zamba2-1.2b", "whisper-small"]
LR = 1e-3


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
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        n = int(((a - b).abs() > tol).sum())
        if n:
            bad[pytree.keystr(k)] = n
    return bad


def _ranks_case():
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    opt_cfg = adamw.AdamWConfig(lr=LR, schedule=schedule.constant())
    out = {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype="float32")
        params = bridge.init_params(cfg, seed=0, device="cpu",
                                    keep_param_dtype=True)
        batch = SyntheticLM(
            cfg.vocab, 8, 8, seed=1,
            frames=((cfg.n_frames, cfg.d_model)
                    if cfg.family == "audio" else None),
            patches=((cfg.n_patches, cfg.d_model)
                     if cfg.family == "vlm" else None)).batch_at(0)
        p1, o1, m1 = train_loop.make_train_step(cfg, opt_cfg)(
            params, adamw.init(params), batch)
        rules = model_zoo.make_rules(cfg, mesh)
        placed = train_loop.place_params(params, cfg, rules)
        p2, _, m2 = train_loop.make_train_step(cfg, opt_cfg, rules)(
            placed, adamw.init(placed), batch)
        out[arch] = {k: (float(m1[k]), float(m2[k]))
                     for k in ("loss", "grad_norm")}
        out[arch]["bad"] = _step_gap(p2, p1, o1.mu)
    return out


@pytest.fixture(scope="module")
def ranks():
    return distributed.run_local(_ranks_case, 8, timeout=300)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_step_on_a_mesh_equals_the_one_rank_step(ranks, arch):
    for r in ranks:
        np.testing.assert_allclose(*r[arch]["loss"], rtol=1e-5)
        np.testing.assert_allclose(*r[arch]["grad_norm"], rtol=1e-4)
        assert r[arch]["bad"] == {}, r[arch]["bad"]
