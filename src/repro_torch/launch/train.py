"""Training launcher.

Port of ``repro/launch/train.py`` on one card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --batch 4 --seq 2048 --steps 12 --ckpt-dir /tmp/ckpt

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 12 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2-moe-a2.7b --smoke --steps 12 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper-small --batch 8 --seq 448 --steps 8

It wires the configs, the fp32 master weights (random, from seed 0,
``bridge.init_params(..., keep_param_dtype=True)``), AdamW with a
warmup-cosine schedule, the ``SyntheticLM`` stream (with a VLM's
``patches`` and the audio family's ``frames``, standard-normal
stand-ins for the stub vision tower's patch embeddings and the stub
audio frontend's frame embeddings, as in the JAX package), the train
step and the ``Trainer`` (async checkpoints with auto-resume, the
straggler watchdog, SIGTERM-safe exit). The config's ``attn_impl`` stays as the
config gives it: training attends through ``chunked_attention``
(``attn_impl="gather"``, every config's default); under
``attn_impl="cuda"`` a step stops at the forward-only flash kernel's
refusal. The MoE family's metrics carry its two aux losses. Every
family trains; ``--mesh`` (multi-device) is refused. Runs on the card;
``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import bridge, resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model_zoo
from repro_torch.optim import adamw, schedule
from repro_torch.train import train_loop


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="multi-device; refused (the dist slice of "
                         "ROADMAP.md)")
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="microbatches per step (0 = config default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the launcher; returns ``{"params", "opt", "metrics",
    "trainer", "start"}`` for callers that inspect the run (None when
    the checkpoint is already past ``--steps``)."""
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh is multi-device; it belongs to the dist slice of "
            "ROADMAP.md (this port trains on one card)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.grad_accum:
        cfg = dataclasses.replace(cfg, grad_accum=args.grad_accum)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"[launch.train] {cfg.name}: "
          f"{model_zoo.count_params(cfg) / 1e6:.1f}M params, "
          f"{n_dev} {device.type} device(s)")

    params = bridge.init_params(cfg, seed=0, device=device,
                                keep_param_dtype=True)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=schedule.warmup_cosine(
            max(args.steps // 20, 1), args.steps))
    opt_state = adamw.init(params)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0,
                       frames=((cfg.n_frames, cfg.d_model)
                               if cfg.family == "audio" else None),
                       patches=((cfg.n_patches, cfg.d_model)
                                if cfg.family == "vlm" else None))

    step_fn = train_loop.make_train_step(cfg, opt_cfg)
    trainer = train_loop.Trainer(
        step_fn, data,
        train_loop.TrainerConfig(ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every, log_every=10))
    start, params, opt_state = trainer.maybe_resume(params, opt_state)
    if start >= args.steps:
        print("[launch.train] checkpoint is already past --steps; done")
        return None
    params, opt_state, metrics = trainer.run(
        params, opt_state, start_step=start, steps=args.steps - start)
    print(f"[launch.train] finished at loss {float(metrics['loss']):.4f}; "
          f"stragglers flagged: {len(trainer.straggler_steps)}")
    return {"params": params, "opt": opt_state, "metrics": metrics,
            "trainer": trainer, "start": start}


if __name__ == "__main__":
    main()
