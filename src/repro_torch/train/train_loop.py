"""Training loop: the train step and its fault-tolerant runner.

Port of ``repro/train/train_loop.py`` (``make_train_step``,
``make_in_graph_loop``, ``TrainerConfig``, ``Trainer``).

The step is functional, as in the JAX package: it takes the fp32
master tree and the ``AdamWState`` and returns new ones (``optim.adamw``
updates nothing in place), so for a moment both the old and the new
trees are alive: at llama3.2-1b that is twice the 14.8 GB of masters
and moments, until the caller drops the old ones. Inside the step the
masters are cast to the compute dtype once (``bridge.compute_params``,
a differentiable cast), the loss and its gradients come from autograd,
and the gradients arrive in fp32 for AdamW.

On a mesh (``rules`` from ``model_zoo.make_rules`` on a ``DeviceMesh``)
the masters and both AdamW moments are DTensors placed by
``logical_to_sharding(param_axes(cfg), rules)`` (``place_params``), and
stay so between steps. Each microbatch's rows are split over the data
axes (the JAX step's ``constrain`` of the batch to ``BATCH``). The
model code is the single-device code: DTensor's propagation takes the
place of the JAX model's ``constrain`` calls, tensors the model makes
(masks, positions) count as replicated
(``implicit_replication``), and the gradients are redistributed to
their masters' placements (the data axes' all-reduce) before AdamW.

Attention in training goes through ``chunked_attention`` and autograd:
the flash-attention kernel is forward-only in both packages, so a step
under ``attn_impl="cuda"`` at a length that routes to it stops at the
kernel's refusal, as the JAX package stops at ``jax.grad``.

Includes the paper's §2.2 "other usage": an in-graph training loop, k
optimizer steps in one ``core.fori_loop``. Fault tolerance: auto-resume
from the latest manifest, async checkpoints every N steps, SIGTERM →
synchronous save → clean exit, a per-step watchdog that flags
stragglers against an EWMA deadline, deterministic data replay from
(seed, step, host).
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import bridge, core
from ..checkpointing import checkpoint as ckpt_lib
from ..dist import pipeline as pipeline_lib
from ..dist import sharding as sh
from ..models import model_zoo
from ..optim import adamw


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on ``device``: integer
    leaves (``tokens``, ``labels``) as int64, floating ones (a VLM's
    ``patches``) as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        dt = torch.float32 if t.is_floating_point() else torch.int64
        out[k] = t.to(device, dt)
    return out


def _without_stage(params, stage_axis: str = "stage"):
    """(to_sub, from_sub) for a tree of DTensors replicated over
    ``stage_axis``: ``to_sub`` gives a leaf as a DTensor on the mesh
    without that axis (a plain tensor when no other axis is left), and
    ``from_sub`` brings one back, replicated over the axis. Identities
    for plain tensors and meshes without the axis."""
    from torch.distributed.tensor import DTensor, Replicate
    leaf = pytree.tree_leaves(params)[0]
    names = getattr(getattr(leaf, "device_mesh", None), "mesh_dim_names",
                    None) or ()
    if stage_axis not in names:
        return (lambda x: x), (lambda x: x)
    mesh, at = leaf.device_mesh, names.index(stage_axis)
    rest = tuple(n for n in names if n != stage_axis)
    sub = mesh[rest] if rest else None

    def to_sub(x):
        if x.placements[at] != Replicate():
            raise ValueError(f"a master placed {x.placements} is not "
                             f"replicated over {stage_axis!r}")
        if sub is None:
            return x.to_local()
        return DTensor.from_local(
            x.to_local(), sub,
            [p for i, p in enumerate(x.placements) if i != at],
            run_check=False, shape=x.shape, stride=x.stride())

    def from_sub(x):
        local, pl = ((x, []) if sub is None else
                     (x.to_local(), list(x.placements)))
        pl.insert(at, Replicate())
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return to_sub, from_sub


def place_params(tree, cfg, rules: sh.ShardingRules):
    """A parameter (or moment) tree as DTensors on ``rules.mesh``, each
    leaf placed by its logical axes (``model_zoo.param_axes``). Every
    rank passes the same full tree."""
    return sh.distribute_tree(
        tree, sh.logical_to_sharding(model_zoo.param_axes(cfg), rules),
        rules.mesh)


def loss_and_grads(params, cfg, batch: Dict, rules=None):
    """(loss, metrics, gradients) of one batch of tensors: the train
    step's forward and backward without the update. On a mesh
    (``params`` DTensors from ``place_params``) the batch's rows are
    split over the data axes of the masters' mesh, and the gradients
    come back in their masters' placements."""
    leaves, spec = pytree.tree_flatten(params)
    sharded = sh.is_dtensor(leaves[0])
    live = [p.detach().requires_grad_() for p in leaves]
    ctx = contextlib.nullcontext()
    if sharded:
        # tensors the model makes (masks, positions, chunk pads) meet
        # DTensors as replicated ones
        from torch.distributed.tensor.experimental import \
            implicit_replication
        ctx = implicit_replication()
        on = leaves[0].device_mesh
        batch = {k: sh.distribute_local(v, on, rules.sharding(
            (sh.BATCH,) + (None,) * (v.dim() - 1), mesh=on,
            dims=tuple(v.shape))) for k, v in batch.items()}
    with torch.enable_grad(), ctx:
        loss, metrics = model_zoo.loss_fn(
            bridge.compute_params(pytree.tree_unflatten(live, spec), cfg),
            cfg, batch)
        grads = torch.autograd.grad(loss, live)
    if sharded:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, leaves)]
        loss = loss.full_tensor()
        metrics = {k: v.full_tensor() if sh.is_dtensor(v) else v
                   for k, v in metrics.items()}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.tree_unflatten(list(grads), spec))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, rules=None,
                    donate: bool = True, accum: str = "auto",
                    accum_stages: Optional[int] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the master tree (``bridge.init_params(...,
    keep_param_dtype=True)``; on a mesh, ``place_params`` of it);
    ``batch`` holds ``tokens`` and ``labels`` (numpy arrays or tensors,
    the whole global batch on every rank). ``donate`` is accepted for
    the JAX package's signature and has no effect (eager PyTorch frees
    the old trees when the caller drops them).

    ``cfg.grad_accum > 1`` splits the batch into microbatches; ``accum``
    picks their schedule, as in the JAX package:

    - ``"fori"``: one microbatch after another in a ``core.fori_loop``;
    - ``"pipeline"``: the ``dist.pipeline`` schedule, in which stage
      ``k`` adds the gradient of row-chunk ``k`` of a microbatch, so on
      a ``stage`` mesh axis stage ``k`` of microbatch ``i+1`` overlaps
      stage ``k+1`` of microbatch ``i``. Gradients equal the sequential
      path up to fp32 reassociation. Its carry holds a gradient-sized
      fp32 tree per microbatch and per slot;
    - ``"auto"``: ``"pipeline"`` under a stage axis of size > 1 when
      the microbatch rows divide the stage count, else ``"fori"``.

    ``accum_stages`` overrides the stage count (default: the mesh's
    ``stage`` axis size), as off-mesh equivalence tests use it.
    """
    if accum not in ("auto", "fori", "pipeline"):
        raise ValueError(f"unknown accum {accum!r}")
    del donate
    n_micro = max(1, cfg.grad_accum)
    mesh = rules.mesh if rules is not None else None
    n_stages = (accum_stages if accum_stages is not None
                else pipeline_lib.stage_count(mesh))

    def zeros_f32(p, lead=()):
        """fp32 zeros of ``lead + p.shape``, a DTensor placed as ``p``
        (its shards one dim further in) when ``p`` is one."""
        if not sh.is_dtensor(p):
            return torch.zeros(lead + tuple(p.shape), dtype=torch.float32,
                               device=p.device)
        from torch.distributed.tensor import DTensor, Shard
        local = p.to_local()
        shape = torch.Size(lead + tuple(p.shape))
        return DTensor.from_local(
            local.new_zeros(lead + tuple(local.shape), dtype=torch.float32),
            p.device_mesh, [Shard(pl.dim + len(lead)) if pl.is_shard()
                            else pl for pl in p.placements],
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    def accum_fori(params, micro):
        def body(i, acc):
            gsum, lsum = acc
            loss, _, g = loss_and_grads(
                params, cfg, {k: v[i] for k, v in micro.items()}, rules)
            return (pytree.tree_map(torch.add, gsum, g), lsum + loss)

        gz = pytree.tree_map(zeros_f32, params)
        lz = torch.zeros((), dtype=torch.float32,
                         device=pytree.tree_leaves(params)[0].device)
        with torch.no_grad():      # the accumulation loop is not differentiated
            grads, loss_sum = core.fori_loop(0, n_micro, body, (gz, lz))
        return (pytree.tree_map(lambda g: g / n_micro, grads),
                loss_sum / n_micro)

    def accum_pipeline(params, micro):
        mb_rows = next(iter(micro.values())).shape[1]
        chunk = mb_rows // n_stages
        # Stage ranks hold different slots, so inside the schedule the
        # masters live on the mesh without its stage axis (a rank's
        # group of the other axes, all at its stage coordinate); the
        # schedule's broadcast from the last stage makes the result
        # the same on every stage rank, replicated on the full mesh.
        to_sub, from_sub = _without_stage(params)
        params = pytree.tree_map(to_sub, params)

        # make_pipelined_fn's SPMD form with the stage index as the
        # "stage weights": stage k adds the gradient of row-chunk k of
        # the slot's microbatch into the slot's carry
        def stage_fn(k, c):
            k = int(k)
            loss, _, g = loss_and_grads(params, cfg, {
                n: v[k * chunk:(k + 1) * chunk] for n, v in c["mb"].items()},
                rules)
            return {"mb": c["mb"], "g": pytree.tree_map(torch.add, c["g"], g),
                    "loss": c["loss"] + loss}

        fn = pipeline_lib.make_pipelined_fn(stage_fn, mesh,
                                            parallel_iterations=n_stages)
        device = pytree.tree_leaves(params)[0].device
        init = {"mb": micro,
                "g": pytree.tree_map(lambda p: zeros_f32(p, (n_micro,)),
                                     params),
                "loss": torch.zeros((n_micro,), dtype=torch.float32,
                                    device=device)}
        with torch.no_grad():      # the accumulation is not differentiated
            out = fn(torch.arange(n_stages), init)
        # each microbatch's carry holds the sum over k of the gradient of
        # chunk k's mean; the microbatch mean is 1/S of it (equal chunks)
        denom = n_micro * n_stages
        return (pytree.tree_map(lambda g: from_sub(g.sum(0) / denom),
                                out["g"]),
                out["loss"].sum() / denom)

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, pytree.tree_leaves(params)[0].device)
        if n_micro == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, rules)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                  *v.shape[1:]) for k, v in batch.items()}
            mb_rows = next(iter(micro.values())).shape[1]
            use_pipe = accum == "pipeline" or (
                accum == "auto" and n_stages > 1
                and mb_rows % max(n_stages, 1) == 0)
            if use_pipe:
                if mb_rows % n_stages != 0:
                    raise ValueError(
                        f"accum='pipeline' needs microbatch rows "
                        f"({mb_rows}) divisible by stages ({n_stages})")
                grads, loss = accum_pipeline(params, micro)
            else:
                grads, loss = accum_fori(params, micro)
            metrics = {"loss": loss, "ce": loss}
        with torch.no_grad():
            params, opt_state, om = adamw.apply(opt_cfg, params, grads,
                                                opt_state)
        om = {k: v.full_tensor() if sh.is_dtensor(v) else v
              for k, v in om.items()}
        return params, opt_state, {**metrics, **om}

    return train_step


def make_in_graph_loop(cfg, opt_cfg: adamw.AdamWConfig, n_inner: int,
                       rules=None) -> Callable:
    """n_inner optimizer steps in one ``core.fori_loop`` (paper §2.2).

    batches: a dict whose arrays are stacked on a leading (n_inner, ...)
    dim, staged on the device once; the loop indexes step ``i``'s batch
    there. Returns (params, opt_state, metrics of the last step)."""
    step_fn = make_train_step(cfg, opt_cfg, rules)

    def loop(params, opt_state, batches):
        device = pytree.tree_leaves(params)[0].device
        staged = batch_to_device(batches, device)

        def body(i, carry):
            params, opt_state, _ = carry
            return step_fn(params, opt_state,
                           {k: v[i] for k, v in staged.items()})

        with torch.no_grad():
            return core.fori_loop(0, n_inner, body,
                                  (params, opt_state, None))

    return loop


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_last: int = 3
    straggler_factor: float = 3.0   # deadline = factor x EWMA step time
    log_every: int = 10


def _any_rank(flag: bool) -> bool:
    """Is ``flag`` set on any rank of the default group?"""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device="cuda" if dist.get_backend() == "nccl"
                     else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class Trainer:
    """Fault-tolerant runner around a train step. ``history`` keeps
    (step, loss, seconds) of every step it ran; the SIGTERM handler it
    installs is put back when ``run`` returns."""

    def __init__(self, step_fn: Callable, data_source, tcfg: TrainerConfig,
                 log_fn: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.data = data_source
        self.tcfg = tcfg
        self.log = log_fn
        self.saver = ckpt_lib.AsyncSaver()
        self._preempted = False
        self._ewma: Optional[float] = None
        self.straggler_steps: list = []
        self.history: list = []

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not on the main thread (tests)
            return None

    def maybe_resume(self, params, opt_state, shardings=None
                     ) -> Tuple[int, Any, Any]:
        """Resume from the latest checkpoint if one exists. ``shardings``
        (a tree over ``{"params", "opt"}`` of ``sharding.NamedSharding``,
        ``checkpoint.restore``'s) lays the restored state out on a mesh;
        without it a DTensor leaf is restored as it is laid out, so a
        sharded run resumes onto its own mesh, whatever mesh wrote the
        checkpoint."""
        if not self.tcfg.ckpt_dir:
            return 0, params, opt_state
        step = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return 0, params, opt_state
        state = ckpt_lib.restore(self.tcfg.ckpt_dir, step,
                                 {"params": params, "opt": opt_state},
                                 shardings)
        self.log(f"[trainer] resumed from step {step}")
        return step, state["params"], state["opt"]

    def run(self, params, opt_state, *, start_step: int = 0, steps: int = 100
            ) -> Tuple[Any, Any, Dict]:
        previous = self._install_sigterm()
        try:
            return self._run(params, opt_state, start_step, steps)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, params, opt_state, start_step, steps):
        metrics = {}
        # a sharded run saves from every rank (one writer): a SIGTERM that
        # reached any rank stops them all at the same step
        sharded = ckpt_lib._distributed({"params": params})
        for step in range(start_step, start_step + steps):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            self.history.append((step, loss, dt))
            # straggler watchdog (EWMA deadline)
            if self._ewma is not None and \
                    dt > self.tcfg.straggler_factor * self._ewma:
                self.straggler_steps.append(step)
                self.log(f"[watchdog] step {step} took {dt * 1e3:.1f}ms "
                         f"(> {self.tcfg.straggler_factor:.1f}x EWMA "
                         f"{self._ewma * 1e3:.1f}ms)")
            self._ewma = dt if self._ewma is None else \
                0.9 * self._ewma + 0.1 * dt
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({dt * 1e3:.1f}ms)")
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self.saver.save_async(
                    self.tcfg.ckpt_dir, step + 1,
                    {"params": params, "opt": opt_state},
                    keep_last=self.tcfg.keep_last)
            if sharded:
                self._preempted = _any_rank(self._preempted)
            if self._preempted:
                self.log(f"[trainer] SIGTERM at step {step}; checkpointing")
                self.saver.wait()
                if self.tcfg.ckpt_dir:
                    ckpt_lib.save(self.tcfg.ckpt_dir, step + 1,
                                  {"params": params, "opt": opt_state},
                                  keep_last=self.tcfg.keep_last)
                break
        self.saver.wait()
        return params, opt_state, metrics
