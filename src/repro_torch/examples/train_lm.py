"""End to end: train a language model with the full stack (the
config zoo, the data pipeline, AdamW with a warmup-cosine schedule,
checkpoints with auto-resume, the straggler watchdog), the JAX
package's ``examples/train_lm.py`` in the port.

By default it trains the reduced (smoke) smollm; ``--full`` takes the
published smollm-135M config. ``--in-graph K`` runs K optimizer steps in
one ``core.fori_loop`` (the paper's §2.2 in-graph training loop;
``train_loop.make_in_graph_loop``), with the K batches staged on the
device once. Training records a gradient tape, so that loop runs under
the host lowering (``impl="host"``, the differentiable one); the report
names it.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \\
        --in-graph 10 --device cpu

Weights are random, from seed 0 (``bridge.init_params``, fp32 masters).
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import bridge, resolve_device
from ..configs import get_config
from ..data.pipeline import SyntheticLM
from ..models import model_zoo
from ..optim import adamw, schedule
from ..train import train_loop

IN_GRAPH_LOWERING = "core.fori_loop(impl='host')"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--in-graph", type=int, default=0,
                    help="fuse N steps into one in-graph loop (paper §2.2)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args, cfg, params) -> Dict[str, object]:
    """Train ``params`` (fp32 masters on their device) as ``args`` says;
    returns the losses (one a step, or one a fused call of
    ``--in-graph`` steps), ms a step, the loop's lowering and the final
    trees."""
    device = next(iter(params.values())).device
    opt_cfg = adamw.AdamWConfig(
        lr=1e-3, schedule=schedule.warmup_cosine(20, args.steps))
    opt_state = adamw.init(params)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    losses, times = [], []
    if args.in_graph:
        # paper §2.2 "in-graph training loops": k steps fused into one
        # loop; one staging of k batches per call
        k = args.in_graph
        loop = train_loop.make_in_graph_loop(cfg, opt_cfg, k)
        step = 0
        while step < args.steps:
            batches = {key: np.stack([data.batch_at(step + i)[key]
                                      for i in range(k)])
                       for key in ("tokens", "labels")}
            _sync(device)
            t0 = time.perf_counter()
            params, opt_state, metrics = loop(params, opt_state, batches)
            loss = float(metrics["loss"])        # waits for the call
            times.append((time.perf_counter() - t0) / k)
            losses.append(loss)
            step += k
            print(f"[train_lm] step {step} loss {loss:.4f} (in-graph x{k}, "
                  f"{IN_GRAPH_LOWERING})")
        lowering = IN_GRAPH_LOWERING
    else:
        step_fn = train_loop.make_train_step(cfg, opt_cfg)
        trainer = train_loop.Trainer(
            step_fn, data,
            train_loop.TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100,
                                     log_every=20))
        start, params, opt_state = trainer.maybe_resume(params, opt_state)
        params, opt_state, metrics = trainer.run(
            params, opt_state, start_step=start, steps=args.steps - start)
        losses = [h[1] for h in trainer.history]
        times = [h[2] for h in trainer.history]
        print(f"[train_lm] done: loss {float(metrics['loss']):.4f}")
        lowering = "python loop of train steps"
    ms = 1e3 * float(np.median(times)) if times else 0.0
    print(f"[train_lm] {ms:.1f} ms a step (median), loop: {lowering}")
    return {"losses": losses, "ms_per_step": ms, "lowering": lowering,
            "params": params, "opt": opt_state}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    print(f"[train_lm] {cfg.name}: "
          f"{model_zoo.count_params(cfg) / 1e6:.1f}M params")
    params = bridge.init_params(cfg, seed=0, device=device,
                                keep_param_dtype=True)
    return train(args, cfg, params)


if __name__ == "__main__":
    main()
