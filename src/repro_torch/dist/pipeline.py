"""Microbatch pipeline parallelism over a ``stage`` mesh axis (paper §4.3).

Port of ``repro/dist/pipeline.py``. The paper's claim is that iterations
of an in-graph loop run concurrently across devices: with the loop body
cut into stages on different devices, stage ``k`` of iteration ``i+1``
overlaps stage ``k+1`` of iteration ``i``. As in the JAX package this
is a **shifted-buffer schedule**: a buffer with one slot per stage
advances every step, every stage computes its slot (a different
microbatch each), then the buffer rotates by one slot. ``S`` stages and
``M`` microbatches take ``M + S - 1`` steps, ``S - 1`` of them fill and
drain, so the busy share is ``M / (M + S - 1)`` and raising the
microbatches in flight shrinks the bubble (the paper's Fig. 12).

Off a mesh (or on a mesh without a "stage" axis) the whole buffer is in
one process and the rotation is a roll of the slot list. On a
``DeviceMesh`` with a "stage" axis of size ``A`` each stage rank holds
``S / A`` consecutive slots (``S`` must be a multiple of ``A``) and the
rotation is a ring shift between stage ranks (``batch_isend_irecv``:
each rank sends its last slot to the next stage rank and receives the
previous rank's), the JAX package's collective-permute. The rotation is
one autograd node a step over all of the rank's slots, whose backward
shifts the cotangents the other way, so the backward's shifts run in one
chain, in the same order on every rank; a value that autograd would
otherwise drop on one rank only (a slot overwritten by the feed, the
last step's buffer) is tied into the chain with a zero cotangent, since
a peer's matching exchange would wait for it forever. Microbatches are
fed on the first stage rank and drained on the last, whose outputs are
then broadcast to the stage group; in the backward the output's
cotangent is taken on the last rank only and the microbatches'
cotangent is broadcast from the first, after the whole chain, so every
rank of the group ends with the one replicated result and its
gradients. The stack-saving policies that recompute a step in the
backward ("carry", "carry_offload") would repeat its exchange there and
are refused on a stage mesh.

The other mesh axes stay independent: the schedule communicates only
inside this rank's stage group, so ranks that differ on a data axis run
their own schedules and nothing is summed across them (the JAX
package's (data=2, stage) mesh once returned twice the activations
that way, its DESIGN.md §6.2).

A slot that holds no microbatch at a step (fill and drain) is passed
through without running its stage; the results are those of the JAX
schedule, which computes it and discards it. Everything runs through
``core.fori_loop``, so the schedule is reverse-differentiable under the
save-stack policies. ``COUNTS`` counts the schedule steps, the stage
calls, the ring shifts (forward and backward) and the all-reduces of
this module, for tests to read in place of the JAX tests' HLO checks.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from .. import core
from .sharding import distribute_local, is_dtensor, mesh_shape

__all__ = ["pipeline_loop", "make_pipelined_fn", "distributed_while",
           "stage_count", "schedule_unroll", "COUNTS", "reset_counts"]

COUNTS = {"steps": 0, "stage_calls": 0, "ring_shifts": 0,
          "ring_shifts_grad": 0, "all_reduces": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def stage_count(mesh, stage_axis: str = "stage") -> int:
    """Size of the pipeline-stage axis of ``mesh`` (1 when absent)."""
    if mesh is None:
        return 1
    try:
        return int(mesh_shape(mesh).get(stage_axis, 1))
    except AttributeError:  # not a mesh
        return 1


def schedule_unroll(mesh, parallel_iterations: int,
                    stage_axis: str = "stage") -> int:
    """Unroll window for a counted loop under a stage mesh: at least
    one full stage rotation (``core.while_loop`` consults this when
    ``parallel_iterations > 1`` with ``mesh=``)."""
    return max(int(parallel_iterations), stage_count(mesh, stage_axis))


# ------------------------------------------------------------ the ring

class _Ring:
    """This rank's place on the stage axis: its group, its coordinate,
    its slots and its neighbours' global ranks."""

    def __init__(self, mesh, stage_axis: str, n_stages: int):
        self.size = mesh_shape(mesh)[stage_axis]
        if n_stages % self.size:
            raise ValueError(f"{n_stages} stages do not divide over a "
                             f"{stage_axis!r} axis of {self.size}")
        self.group = mesh.get_group(stage_axis)
        self.index = mesh.get_local_rank(stage_axis)
        self.per = n_stages // self.size
        self.lo = self.index * self.per
        self.next = dist.get_global_rank(self.group,
                                         (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(self.group,
                                         (self.index - 1) % self.size)

    def rank_of(self, index: int) -> int:
        return dist.get_global_rank(self.group, index)


def _ring(mesh, stage_axis: str, n_stages: int) -> Optional[_Ring]:
    if stage_count(mesh, stage_axis) == 1:
        return None
    if not hasattr(mesh, "get_group"):
        raise TypeError("a pipeline over a stage axis needs a DeviceMesh")
    return _Ring(mesh, stage_axis, n_stages)


def _exchange(tensors, send_to: int, recv_from: int, group) -> List:
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), send_to, group))
        ops.append(dist.P2POp(dist.irecv, o, recv_from, group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """One step's rotation of this rank's slots (their leaves in slot
    order): the last slot goes to the next stage rank, the previous
    rank's last slot comes in as the first, the others move up one.
    One node takes the whole buffer, so the rotations of successive
    steps form one chain and their backwards run in the same order on
    every rank; each sends the cotangent of the slot it received back."""

    @staticmethod
    def forward(ctx, ring, n_last, *leaves):
        ctx.ring, ctx.n_last = ring, n_last
        ctx.float = [t.is_floating_point() for t in leaves]
        COUNTS["ring_shifts"] += 1
        cut = len(leaves) - n_last
        outs = _exchange(leaves[cut:], ring.next, ring.prev, ring.group) \
            + [t.view_as(t) for t in leaves[:cut]]
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        r, n = ctx.ring, ctx.n_last
        cut = len(ctx.float) - n
        COUNTS["ring_shifts_grad"] += 1
        last_float = ctx.float[cut:]
        sent = iter(_exchange([g for g, f in zip(grads[:n], last_float)
                               if f], r.prev, r.next, r.group))
        keep = [g if f else None for g, f in zip(grads[n:], ctx.float)]
        return (None, None, *keep,
                *[next(sent) if f else None for f in last_float])


class _Tie(torch.autograd.Function):
    """Returns its first ``n`` inputs unchanged and gives the others a
    zero cotangent. Tying a value into the schedule makes its backward
    run on every rank of the ring at the same point of the chain, where
    autograd alone would skip it on a rank whose loss does not reach it
    (a peer's collective would then wait forever)."""

    @staticmethod
    def forward(ctx, n, *tensors):
        ctx.n = n
        ctx.rest = [(t.shape, t.dtype, t.device, t.is_floating_point())
                    for t in tensors[n:]]
        outs = [t.view_as(t) for t in tensors[:n]]
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads, *[
            torch.zeros(sh, dtype=dt, device=dev) if f else None
            for sh, dt, dev, f in ctx.rest])


class _FromStage(torch.autograd.Function):
    """Broadcast from one stage rank to the group; the cotangent of the
    (replicated) result is taken on that rank alone."""

    @staticmethod
    def forward(ctx, ring, src, *tensors):
        ctx.mine = ring.index == src
        outs = []
        for t in tensors:
            o = t.detach().clone().contiguous()
            dist.broadcast(o, ring.rank_of(src), group=ring.group)
            outs.append(o)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None,
                *[g if ctx.mine else torch.zeros_like(g) for g in grads])


class _ToStage(torch.autograd.Function):
    """Identity on inputs every stage rank holds but only ``src`` reads;
    the backward broadcasts the cotangent from ``src``."""

    @staticmethod
    def forward(ctx, ring, src, *tensors):
        ctx.ring, ctx.src = ring, src
        outs = [t.view_as(t) for t in tensors]
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        outs = []
        for g in grads:
            if g is not None and g.is_floating_point():
                g = g.contiguous().clone()
                dist.broadcast(g, ctx.ring.rank_of(ctx.src),
                               group=ctx.ring.group)
            outs.append(g)
        return (None, None, *outs)


class _StageSlice(torch.autograd.Function):
    """This rank's slots of a stage-stacked tensor every stage rank
    holds whole; the backward all-reduces the (disjoint) slot gradients
    so the whole gradient is on every rank."""

    @staticmethod
    def forward(ctx, ring, w):
        ctx.ring, ctx.shape = ring, w.shape
        return w[ring.lo:ring.lo + ring.per].clone()

    @staticmethod
    def backward(ctx, g):
        r = ctx.ring
        full = g.new_zeros(ctx.shape)
        full[r.lo:r.lo + r.per] = g
        COUNTS["all_reduces"] += 1
        dist.all_reduce(full, group=r.group)
        return None, full


def _tree_apply(fn, tree):
    """``fn(*tensors)`` over a tree's tensor leaves, DTensors as their
    local shards (rebuilt around the results, which come back in the
    same order and kinds)."""
    from torch.distributed.tensor import DTensor
    leaves, spec = pytree.tree_flatten(tree)
    outs = fn(*[x.to_local() if isinstance(x, DTensor) else x
                for x in leaves])
    back = [DTensor.from_local(o, x.device_mesh, x.placements,
                               run_check=False, shape=x.shape,
                               stride=x.stride())
            if isinstance(x, DTensor) else o for o, x in zip(outs, leaves)]
    return pytree.tree_unflatten(back, spec)


def _locals(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in pytree.tree_leaves(tree)]


def _same_kind(a, b) -> bool:
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(x.shape == y.shape and x.dtype == y.dtype
                            for x, y in zip(la, lb))


# ------------------------------------------------------------ schedule

def _run_schedule(stage: Callable, microbatches: Any, n_stages: int,
                  ring: Optional[_Ring], *, save_policy: str,
                  parallel_iterations: int, mesh, tied=()) -> Any:
    """Drive the shifted-buffer schedule. ``stage(g, x)`` runs global
    stage ``g`` on one slot. Returns the stacked ``(n_micro, ...)``
    outputs of the last stage, in microbatch order. On a ring, ``tied``
    are tensors whose backward holds a collective (this rank's stage
    weights), tied into the first step."""
    n_micro = pytree.tree_leaves(microbatches)[0].shape[0]
    per, lo = (n_stages, 0) if ring is None else (ring.per, ring.lo)
    if ring is not None and save_policy in ("carry", "carry_offload"):
        raise ValueError(
            f"save_policy={save_policy!r} recomputes each step in the "
            f"backward, which would repeat the ring shift on a stage mesh; "
            f"use 'all' or 'offload' there")
    if ring is not None:
        microbatches = _tree_apply(
            lambda *xs: _ToStage.apply(ring, 0, *xs), microbatches)
    mbs = [pytree.tree_map(lambda x, m=m: x[m], microbatches)
           for m in range(n_micro)]
    zero = pytree.tree_map(torch.zeros_like, mbs[0])
    if ring is not None:
        # the inputs' and weights' backward collectives run after the
        # whole schedule's, on every rank
        n = len(pytree.tree_leaves(zero))
        zero = _tree_apply(lambda *xs: _Tie.apply(
            n, *xs, *_locals(microbatches), *tied), zero)
    total = n_micro + n_stages - 1
    last = lo + per == n_stages

    def body(t, carry):
        buf, out = carry
        COUNTS["steps"] += 1
        if lo == 0 and t < n_micro:                     # fill slot 0
            fed = mbs[t]
            if ring is not None:    # the replaced slot stays in the chain
                n = len(pytree.tree_leaves(fed))
                fed = _tree_apply(lambda *xs: _Tie.apply(
                    n, *xs, *_locals(buf[0])), fed)
            buf = [fed] + buf[1:]
        y = []
        for k, x in enumerate(buf):                     # advance
            g = lo + k
            if 0 <= t - g < n_micro:
                COUNTS["stage_calls"] += 1
                new = stage(g, x)
                if not _same_kind(new, x):
                    raise ValueError(
                        "pipeline stages must be shape-preserving (slot "
                        "k's output feeds slot k+1); stage "
                        f"{g} mapped {pytree.tree_map(lambda a: a.shape, x)}"
                        f" to {pytree.tree_map(lambda a: a.shape, new)}")
                x = new
            y.append(x)
        if last and t >= n_stages - 1:                  # drain
            m = t - (n_stages - 1)
            out = out[:m] + [y[-1]] + out[m + 1:]
        if ring is None:                                # rotate
            return [y[-1]] + y[:-1], out
        # every slot has one structure, so the rotation's outputs,
        # [received slot] + y[:-1], take the slots' places in order
        n_last = len(pytree.tree_leaves(y[-1]))
        return _tree_apply(lambda *xs: _Rotate.apply(ring, n_last, *xs),
                           y), out

    buf, out = core.fori_loop(0, total, body, ([zero] * per,
                                               [zero] * n_micro),
                              save_policy=save_policy,
                              parallel_iterations=parallel_iterations,
                              mesh=mesh)
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *out)
    if ring is None:
        return stacked
    n = len(pytree.tree_leaves(stacked))
    stacked = _tree_apply(
        lambda *xs: _Tie.apply(n, *xs, *_locals(buf)), stacked)
    return _tree_apply(
        lambda *xs: _FromStage.apply(ring, ring.size - 1, *xs), stacked)


def pipeline_loop(stage_fns, init: Any, n_microbatches: Optional[int] = None,
                  mesh=None, *, stage_axis: str = "stage",
                  save_policy: str = "all",
                  parallel_iterations: int = 1) -> Any:
    """Run stacked microbatches through a chain of stages, pipelined.

    Args:
      stage_fns: per-stage callables ``x -> x``; every stage preserves
        the microbatch's shape (slot ``k``'s output feeds slot ``k+1``).
      init: tree of microbatched inputs, leading dim ``n_microbatches``
        (on a stage mesh, the same on every rank).
      n_microbatches: optional check against ``init``'s leading dim.
      mesh: optional ``DeviceMesh``; with a ``stage_axis`` axis each
        stage rank runs its slots and the rotation is a ring shift.
      save_policy / parallel_iterations: forwarded to
        ``core.fori_loop`` (``parallel_iterations`` widens the unroll
        window under "all" only).

    Returns:
      The last stage's outputs stacked on a leading ``n_microbatches``
      dim, in microbatch order; equal to running each microbatch through
      every stage in turn.
    """
    stage_fns = list(stage_fns)
    if not stage_fns:
        raise ValueError("pipeline_loop needs at least one stage")
    n_micro = pytree.tree_leaves(init)[0].shape[0]
    if n_microbatches is not None and n_microbatches != n_micro:
        raise ValueError(f"init has {n_micro} microbatches, "
                         f"n_microbatches={n_microbatches}")
    n_stages = len(stage_fns)
    ring = _ring(mesh, stage_axis, n_stages)
    return _run_schedule(lambda g, x: stage_fns[g](x), init, n_stages, ring,
                         save_policy=save_policy,
                         parallel_iterations=parallel_iterations, mesh=mesh)


def _local_stages(w, ring: Optional[_Ring], stage_axis: str):
    """This rank's rows of a stage-stacked leaf: a DTensor sharded on
    dim 0 over the stage axis gives its local shard; a tensor every
    rank holds whole is sliced (its gradient all-reduced)."""
    if ring is None:
        return w.full_tensor() if is_dtensor(w) else w
    if is_dtensor(w):
        from torch.distributed.tensor import Shard
        dim = w.device_mesh.mesh_dim_names.index(stage_axis)
        if w.placements[dim] != Shard(0):
            raise ValueError(f"stage-stacked weights must be sharded on "
                             f"dim 0 over {stage_axis!r}; got "
                             f"{w.placements}")
        return w.to_local()
    if not w.is_floating_point():
        return w[ring.lo:ring.lo + ring.per]
    return _StageSlice.apply(ring, w)


def make_pipelined_fn(stage_fn: Callable, mesh, stage_axis: str = "stage",
                      parallel_iterations: int = 1, *,
                      save_policy: str = "all") -> Callable:
    """SPMD form: one stage body, weights stacked on a stage dim.

    Returns ``fn(stage_params, microbatches)``: ``stage_params`` is a
    tree stacked ``(n_stages, ...)`` (on a stage mesh, a DTensor
    sharded on dim 0 over ``stage_axis``, each stage rank holding its
    own rows, or a tensor every rank holds whole), ``microbatches`` is
    stacked ``(n_microbatches, ...)``. Each step runs
    ``stage_fn(params_k, slot_k)`` on this rank's slots, then rotates
    the buffer. ``parallel_iterations`` is the §4.3 knob, the unroll
    window of the schedule loop.
    """

    def fn(stage_params, microbatches):
        n_stages = pytree.tree_leaves(stage_params)[0].shape[0]
        ring = _ring(mesh, stage_axis, n_stages)
        local = pytree.tree_map(
            lambda w: _local_stages(w, ring, stage_axis), stage_params)
        lo = 0 if ring is None else ring.lo
        slots = [pytree.tree_map(lambda w, k=k: w[k], local)
                 for k in range(n_stages if ring is None else ring.per)]
        tied = () if ring is None else [
            w for w in pytree.tree_leaves(local) if w.is_floating_point()]
        return _run_schedule(lambda g, x: stage_fn(slots[g - lo], x),
                             microbatches, n_stages, ring,
                             save_policy=save_policy,
                             parallel_iterations=parallel_iterations,
                             mesh=mesh, tied=tied)

    return fn


def distributed_while(body_fn: Callable, n_iters: int, x_example, *,
                      mesh=None, axis: Optional[str] = None,
                      barrier: bool = False) -> Callable:
    """Distributed while-loop runner (the paper's Fig. 11 experiment).

    Returns ``fn(x)``, which runs ``body_fn`` ``n_iters`` times with the
    tensor ``x`` sharded on dim 0 over ``axis`` of ``mesh`` (every rank
    passes the whole ``x``; the result is a DTensor). Each rank iterates
    its own shard. ``barrier=True`` adds one all-reduce of the scalar
    sum per iteration, every shard waiting on a global scalar before its
    next step; the sum enters the carry scaled by 1e-30, which leaves
    the values as they are but keeps the dependency (the JAX package's
    construction, there so that XLA cannot remove it). Off a mesh, or
    without ``axis``, it is a plain counted loop.
    """
    names = list(mesh_shape(mesh))
    sharded = axis is not None and axis in names
    if sharded:
        from torch.distributed.tensor import Replicate, Shard
        placements = [Shard(0) if n == axis else Replicate() for n in names]
        group = mesh.get_group(axis)
        if x_example.shape[0] % mesh_shape(mesh)[axis]:
            raise ValueError(f"dim 0 of x ({x_example.shape[0]}) does not "
                             f"divide over {axis!r}")

    def run(x):
        if sharded:
            from torch.distributed.tensor import DTensor
            x = (x.redistribute(mesh, placements) if isinstance(x, DTensor)
                 else distribute_local(x, mesh, placements))
            local = x.to_local()
        else:
            local = x

        def body(i, c):
            y = body_fn(c)
            if barrier:
                s = y.detach().sum()
                if sharded:
                    COUNTS["all_reduces"] += 1
                    dist.all_reduce(s, group=group)
                y = y + torch.tensor(1e-30, dtype=y.dtype,
                                     device=y.device) * s.to(y.dtype)
            return y

        out = core.fori_loop(0, n_iters, body, local)
        if not sharded:
            return out
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, mesh, placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return run
