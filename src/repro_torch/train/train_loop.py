"""Training loop: the train step and its fault-tolerant runner.

Port of ``repro/train/train_loop.py`` (``make_train_step``,
``make_in_graph_loop``, ``TrainerConfig``, ``Trainer``), on one card.

The step is functional, as in the JAX package: it takes the fp32
master tree and the ``AdamWState`` and returns new ones (``optim.adamw``
updates nothing in place), so for a moment both the old and the new
trees are alive: at llama3.2-1b that is twice the 14.8 GB of masters
and moments, until the caller drops the old ones. Inside the step the
masters are cast to the compute dtype once (``bridge.compute_params``,
a differentiable cast), the loss and its gradients come from autograd,
and the gradients arrive in fp32 for AdamW.

Attention in training goes through ``chunked_attention`` and autograd:
the flash-attention kernel is forward-only in both packages, so a step
under ``attn_impl="cuda"`` at a length that routes to it stops at the
kernel's refusal, as the JAX package stops at ``jax.grad``.

Includes the paper's §2.2 "other usage": an in-graph training loop, k
optimizer steps in one ``core.fori_loop``. Fault tolerance: auto-resume
from the latest manifest, async checkpoints every N steps, SIGTERM →
synchronous save → clean exit, a per-step watchdog that flags
stragglers against an EWMA deadline, deterministic data replay from
(seed, step, host). The multi-device schedules (``accum="pipeline"``,
a mesh) belong to the dist slice of ROADMAP.md and are refused.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import bridge, core
from ..checkpointing import checkpoint as ckpt_lib
from ..models import model_zoo
from ..optim import adamw


def _refuse_dist(what: str) -> None:
    raise NotImplementedError(
        f"{what} is multi-device; it belongs to the dist slice of "
        f"ROADMAP.md (this port trains on one card)")


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


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, rules=None,
                    accum: str = "auto", mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the master tree (``bridge.init_params(...,
    keep_param_dtype=True)``); ``batch`` holds ``tokens`` and
    ``labels`` (numpy arrays or tensors). ``cfg.grad_accum > 1`` splits
    the batch into microbatches and sums their gradients in a
    ``core.fori_loop`` (``accum`` "fori" or "auto"); ``accum="pipeline"``,
    ``rules`` and ``mesh`` are multi-device and refused.
    """
    if accum not in ("auto", "fori", "pipeline"):
        raise ValueError(f"unknown accum {accum!r}")
    if accum == "pipeline":
        _refuse_dist("accum='pipeline'")
    if rules is not None or mesh is not None:
        _refuse_dist("a mesh")
    n_micro = max(1, cfg.grad_accum)

    def grads_of(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, metrics = model_zoo.loss_fn(
                bridge.compute_params(pytree.tree_unflatten(live, spec), cfg),
                cfg, batch)
            grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                pytree.tree_unflatten(list(grads), spec))

    def accum_fori(params, micro):
        def body(i, acc):
            gsum, lsum = acc
            loss, _, g = grads_of(params, {k: v[i] for k, v in micro.items()})
            return (pytree.tree_map(torch.add, gsum, g), lsum + loss)

        gz = pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        lz = torch.zeros((), dtype=torch.float32,
                         device=pytree.tree_leaves(params)[0].device)
        with torch.no_grad():      # the accumulation loop is not differentiated
            grads, loss_sum = core.fori_loop(0, n_micro, body, (gz, lz))
        return (pytree.tree_map(lambda g: g / n_micro, grads),
                loss_sum / n_micro)

    def train_step(params, opt_state, batch):
        device = pytree.tree_leaves(params)[0].device
        batch = batch_to_device(batch, device)
        if n_micro == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads, loss = accum_fori(params, micro)
            metrics = {"loss": loss, "ce": loss}
        with torch.no_grad():
            params, opt_state, om = adamw.apply(opt_cfg, params, grads,
                                                opt_state)
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

    def maybe_resume(self, params, opt_state) -> Tuple[int, Any, Any]:
        """Resume from the latest checkpoint if one exists."""
        if not self.tcfg.ckpt_dir:
            return 0, params, opt_state
        step = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return 0, params, opt_state
        state = ckpt_lib.restore(self.tcfg.ckpt_dir, step,
                                 {"params": params, "opt": opt_state})
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
