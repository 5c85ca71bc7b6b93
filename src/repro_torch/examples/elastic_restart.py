"""Fault-tolerance demo: train, crash, resume, the JAX package's
``examples/elastic_restart.py`` (phases 1 and 2) in the port.

Phase 1 trains 6 steps, checkpointing at step 4, and "crashes". Phase 2
restores the latest checkpoint into fresh state and replays steps 4-5
from the deterministic data stream: the parameters must match the
uninterrupted run (max |difference| < 1e-5). Phase 3 of the reference
restores the checkpoint onto a (4, 2) data x model mesh of 8 devices;
restoring onto a mesh is slice 7c of the port (ROADMAP.md, queue 1
item 7), and the script says so instead of running it.

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


def run(cfg, params0, *, batch: int = 4, seq: int = 32) -> Dict[str, float]:
    """Phases 1 and 2 from the master tree ``params0``; returns the
    losses and the largest parameter difference of the resumed run."""
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
          f"uninterrupted run = {err:.2e} ({exact}; deterministic replay)")
    assert err < RESUME_TOL
    print("[elastic] phase3: not run: restoring onto a (4, 2) mesh is "
          "slice 7c of the port (ROADMAP.md queue 1 item 7)")
    return {"loss": loss1, "resumed_loss": float(m2["loss"]),
            "max_diff": err}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the published smollm-135M config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("smollm-135m", smoke=not args.full)
    params0 = bridge.init_params(cfg, seed=0, device=device,
                                 keep_param_dtype=True)
    return run(cfg, params0)


if __name__ == "__main__":
    main()
