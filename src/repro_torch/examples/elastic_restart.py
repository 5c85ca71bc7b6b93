"""Fault-tolerance demo: train, crash, resume, then restore elastically
onto a mesh: the JAX package's ``examples/elastic_restart.py`` in the
port.

Phase 1 trains 6 steps, checkpointing at step 4, and "crashes". Phase 2
restores the latest checkpoint into fresh state and replays steps 4-5
from the deterministic data stream: the parameters must match the
uninterrupted run (max |difference| < 1e-5). Phase 3 restores the
step-4 checkpoint onto a (4, 2) data x model mesh of 8 ranks
(``checkpoint.restore_latest`` with the masters' and moments' placements
on it), as the JAX package does on 8 forced host devices: here 8 gloo
ranks on the CPU (``launch.distributed.run_local``), whatever device
phases 1 and 2 ran on. It asserts that every leaf is a DTensor on a mesh
of 8 ranks and equals the checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
    PYTHONPATH=src python -m repro_torch.examples.elastic_restart --device cpu

``--full`` takes the published smollm-135M config instead of the
reduced one. Weights are random, from seed 0 (fp32 masters). It runs on
the card unless ``--device cpu`` is given. On the card the replay runs
the same kernels on the same inputs; the report says whether the
difference is exactly 0 (a non-deterministic reduction, such as an
atomic scatter-add in a backward, would make it small but not 0).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Dict, Optional, Sequence

import torch.utils._pytree as pytree

from .. import bridge, resolve_device
from ..checkpointing import checkpoint as ck
from ..configs import get_config
from ..data.pipeline import SyntheticLM
from ..optim import adamw, schedule
from ..train import train_loop

RESUME_TOL = 1e-5
MESH = (4, 2)                    # phase 3: data x model, 8 ranks


def restore_on_mesh(ckpt_dir: str, cfg) -> Dict[str, object]:
    """One rank of phase 3: the latest checkpoint restored onto the
    (4, 2) mesh of the job's ranks; returns the step, how many leaves
    came back as DTensors on a mesh of how many ranks, and the largest
    difference of the gathered leaves from the checkpoint's arrays."""
    import numpy as np
    from ..dist import sharding as sh
    from ..launch import mesh as mesh_lib
    from ..models import model_zoo
    mesh = mesh_lib.make_mesh(MESH, ("data", "model"), "cpu")
    placed = sh.named_shardings(sh.logical_to_sharding(
        model_zoo.param_axes(cfg), model_zoo.make_rules(cfg, mesh)), mesh)
    like = bridge.init_params(cfg, seed=0, device="cpu",
                              keep_param_dtype=True)
    step, state = ck.restore_latest(
        ckpt_dir, {"params": like, "opt": adamw.init(like)},
        {"params": placed, "opt": adamw.AdamWState(step=None, mu=placed,
                                                   nu=placed)})
    leaves = pytree.tree_leaves({"params": state["params"],
                                 "mu": state["opt"].mu,
                                 "nu": state["opt"].nu})
    path = f"{ckpt_dir}/step_{step:09d}/host0.npz"
    with np.load(path) as data:
        want = [data[k] for k, _ in ck._items({"params": like})]
    got = [t.full_tensor() for t in pytree.tree_leaves(state["params"])]
    diff = max(float(np.abs(g.float().numpy() - w).max())
               for g, w in zip(got, want))
    return {"step": step, "leaves": len(leaves),
            "dtensors": sum(sh.is_dtensor(t) for t in leaves),
            "ranks": min(t.device_mesh.size() for t in leaves
                         if sh.is_dtensor(t)),
            "max_diff": diff}


def run(cfg, params0, *, batch: int = 4, seq: int = 32,
        mesh_restore: bool = True) -> Dict[str, float]:
    """Phases 1 and 2 from the master tree ``params0``, then phase 3
    unless ``mesh_restore`` is False; returns the losses and the largest
    parameter difference of the resumed run."""
    opt_cfg = adamw.AdamWConfig(lr=1e-3, schedule=schedule.constant())
    data = SyntheticLM(cfg.vocab, seq, batch, seed=1)
    step = train_loop.make_train_step(cfg, opt_cfg)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # --- phase 1: train 6 steps, checkpoint at 4, "crash"
        p, o = params0, adamw.init(params0)
        for i in range(6):
            p, o, m = step(p, o, data.batch_at(i))
            if i == 3:
                ck.save(ckpt_dir, 4, {"params": p, "opt": o})
        loss1 = float(m["loss"])
        print(f"[elastic] phase1: trained to step 6, loss {loss1:.4f}; "
              f"checkpoint at step 4; CRASH")
        ref = p

        # --- phase 2: fresh state; auto-resume and replay
        got, state = ck.restore_latest(
            ckpt_dir, {"params": params0, "opt": adamw.init(params0)})
        assert got == 4
        p2, o2 = state["params"], state["opt"]
        for i in range(4, 6):
            p2, o2, m2 = step(p2, o2, data.batch_at(i))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(pytree.tree_leaves(ref),
                                  pytree.tree_leaves(p2)))
        exact = "exactly 0" if err == 0 else "not 0"
        print(f"[elastic] phase2: resumed step 4 -> 6; max param diff vs "
              f"uninterrupted run = {err:.2e} ({exact}; deterministic "
              f"replay)")
        assert err < RESUME_TOL
        out = {"loss": loss1, "resumed_loss": float(m2["loss"]),
               "max_diff": err}
        if mesh_restore:
            # --- phase 3: elastic restore on a (4, 2) mesh of 8 ranks
            from ..launch.distributed import run_local
            got = run_local(restore_on_mesh, 8, ckpt_dir, cfg)
            r = got[0]
            print(f"[elastic] phase3: restored step {r['step']} onto a "
                  f"(4,2) mesh spanning {r['ranks']} ranks (8 gloo CPU "
                  f"ranks): {r['dtensors']} of {r['leaves']} leaves "
                  f"DTensors, max |difference| from the checkpoint "
                  f"{r['max_diff']:.2e}")
            assert all(g["ranks"] == 8 and g["dtensors"] == g["leaves"]
                       and g["max_diff"] == 0 and g["step"] == 4
                       for g in got), got
            out["mesh_ranks"] = r["ranks"]
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the published smollm-135M config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-mesh-restore", action="store_true",
                    help="skip phase 3 (8 CPU ranks restoring onto a mesh)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("smollm-135m", smoke=not args.full)
    params0 = bridge.init_params(cfg, seed=0, device=device,
                                 keep_param_dtype=True)
    return run(cfg, params0, mesh_restore=not args.no_mesh_restore)


if __name__ == "__main__":
    main()
