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
family trains. Runs on the card; ``--device cpu`` runs the plain
versions of the kernels.

``--mesh 2,4`` trains on a ``DeviceMesh`` of that shape over the ranks
of the job, its axes ``("data", "model", "stage")[:len(shape)]``, with
the masters and AdamW moments sharded by the config's logical axes
(``train_loop.place_params``). Run it under torchrun, or on local ranks
with ``launch.distributed`` (gloo ranks on the CPU need no network):

    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 8 \
        --device cpu repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 3 --mesh 2,4 --device cpu

A mesh whose size is not the world size raises; a mesh of one device
on a single process gets a group of one. ``--ckpt-dir`` with ``--mesh``
checkpoints the sharded run (every rank gathers, rank 0 writes the one
host file) and resumes onto the mesh given, whatever mesh wrote the
checkpoint (``Trainer.maybe_resume`` with the masters' and moments'
placements on it), as the JAX launcher does:

    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 8 \
        --device cpu repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 2 --mesh 2,4 --ckpt-dir /tmp/ck --ckpt-every 2 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 8 \
        --device cpu repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 4 --mesh 4,2 --ckpt-dir /tmp/ck --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch import bridge, resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import sharding as sh
from repro_torch.launch import distributed
from repro_torch.launch import mesh as mesh_lib
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
                    help="e.g. '4,2' => (data,model) or '2,2,2' => "
                         "(data,model,stage); with a stage axis > 1 and "
                         "--grad-accum > 1, microbatches route through "
                         "the dist.pipeline schedule; default one device")
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
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.grad_accum:
        cfg = dataclasses.replace(cfg, grad_accum=args.grad_accum)
    rules, log, own_group = None, print, False
    if args.mesh:
        rules, own_group = _mesh_rules(args, cfg, device)
        if torch.distributed.get_rank() != 0:
            log = _quiet
    try:
        return _train(args, cfg, device, rules, log)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(args, cfg, device, rules, log):
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    log(f"[launch.train] {cfg.name}: "
        f"{model_zoo.count_params(cfg) / 1e6:.1f}M params, "
        f"{n_dev} {device.type} device(s)")

    params = bridge.init_params(cfg, seed=0, device=device,
                                keep_param_dtype=True)
    if rules is not None:
        params = train_loop.place_params(params, cfg, rules)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=schedule.warmup_cosine(
            max(args.steps // 20, 1), args.steps))
    opt_state = adamw.init(params)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0,
                       frames=((cfg.n_frames, cfg.d_model)
                               if cfg.family == "audio" else None),
                       patches=((cfg.n_patches, cfg.d_model)
                                if cfg.family == "vlm" else None))

    step_fn = train_loop.make_train_step(cfg, opt_cfg, rules)
    trainer = train_loop.Trainer(
        step_fn, data,
        train_loop.TrainerConfig(ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every, log_every=10),
        log_fn=log)
    shardings = None
    if rules is not None:
        placed = sh.named_shardings(sh.logical_to_sharding(
            model_zoo.param_axes(cfg), rules), rules.mesh)
        shardings = {"params": placed,
                     "opt": adamw.AdamWState(step=None, mu=placed,
                                             nu=placed)}
    start, params, opt_state = trainer.maybe_resume(params, opt_state,
                                                    shardings)
    if start >= args.steps:
        log("[launch.train] checkpoint is already past --steps; done")
        return None
    params, opt_state, metrics = trainer.run(
        params, opt_state, start_step=start, steps=args.steps - start)
    log(f"[launch.train] finished at loss {float(metrics['loss']):.4f}; "
        f"stragglers flagged: {len(trainer.straggler_steps)}")
    return {"params": params, "opt": opt_state, "metrics": metrics,
            "trainer": trainer, "start": start}


def _quiet(_: str) -> None:
    pass


def _mesh_rules(args, cfg, device):
    """The ``ShardingRules`` of ``--mesh`` on the job's ranks, with the
    JAX launcher's notes on the stage axis."""
    shape = tuple(int(x) for x in args.mesh.split(","))
    axes = ("data", "model", "stage")[:len(shape)]
    distributed.init_distributed(device_type=device.type)
    own_group = False
    if not torch.distributed.is_initialized() and math.prod(shape) == 1:
        # a one-device mesh on one process: a group of one, for this run
        distributed.init_distributed(
            store=torch.distributed.HashStore(), world_size=1, rank=0,
            device_type=device.type)
        own_group = True
    try:
        mesh = mesh_lib.make_mesh(shape, axes, device.type)
    except BaseException:
        if own_group:
            torch.distributed.destroy_process_group()
        raise
    if torch.distributed.get_rank() == 0:
        print(f"[launch.train] mesh {dict(zip(axes, shape))} over "
              f"{torch.distributed.get_world_size()} "
              f"{torch.distributed.get_backend()} rank(s)")
        if len(shape) > 2 and shape[2] > 1:
            if cfg.grad_accum > 1:
                print("[launch.train] stage axis: grad-accum microbatches "
                      "route through the dist.pipeline schedule "
                      "(train_loop accum='auto')")
            else:
                print("[launch.train] note: stage axis without "
                      "--grad-accum > 1 holds replicas; pass --grad-accum "
                      "to pipeline microbatches over it")
    return model_zoo.make_rules(cfg, mesh), own_group


if __name__ == "__main__":
    main()
