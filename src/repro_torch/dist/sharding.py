"""Logical-axis sharding rules (paper §4.3) on a torch ``DeviceMesh``.

Port of ``repro/dist/sharding.py``. Model code never names mesh axes:
parameters carry *logical* axes (``BATCH``, ``MLP``, ``VOCAB``, ...),
and this module binds them to mesh axes once per (config, mesh) pair in
a ``ShardingRules``. What a JAX ``Mesh`` is there, a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names`` is
here, and what a ``NamedSharding`` is there, a tuple of DTensor
placements is here: ``Shard(d)`` or ``Replicate()``, one per mesh dim.

``resolve_rules`` is shape logic. It reads only the names and sizes of
the mesh's axes (``mesh_shape``), so it takes a ``DeviceMesh``, a bare
name -> size mapping (the tests' meshes) or anything with a JAX-style
``shape`` mapping, and gives the same table for the same shape.

Resolution is divisibility-aware, as in the JAX package: a logical
axis binds to "model" only when the model dimension that carries it
divides the axis size, and ``spec(..., dims=)`` and ``constrain`` drop
an axis that does not divide the operand's dimension, so a
sharding annotation is always safe; off a mesh it is a no-op.

Where DTensor's propagation cannot follow the model (the MoE's routing,
the CE's label logits, the chunked attention), the model runs plain
tensors on each rank's part (``split_rows``, ``split_mean``,
``local_heads``), with explicit collectives inside autograd. Serving on
a model axis runs the whole model so: each rank holds its slices of the
weights as plain tensors (``serve_slices``) and its ``ServeSplit`` sums
the parts and gathers the logits.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

__all__ = [
    "BATCH", "SEQ", "ATTN_SEQ", "ACT_SEQ", "EMBED", "MLP", "HEAD", "HEADS",
    "KV_HEADS", "HEAD_DIM", "VOCAB", "EXPERT", "EXPERT_MLP", "INNER",
    "STATE", "LAYERS", "CACHE_KV", "CACHE_HD", "STAGE", "SLOT", "BLOCK",
    "PartitionSpec", "P", "ShardingRules", "mesh_shape", "resolve_rules",
    "is_dtensor",
    "constrain", "local_heads",
    "split_rows", "split_mean", "ModelSplit", "NO_SPLIT", "local_offset",
    "COUNTS", "reset_counts",
    "ServeSplit", "WHOLE", "serve_slices",
    "keep_grad_layout",
    "logical_to_sharding",
    "distribute_local",
    "distribute_tree",
    "carve_slices", "slice_mesh", "transfer_sharding",
    "NamedSharding", "named_shardings", "data_axes", "data_index",
    "gather_objects", "gather_shards", "shard_leader",
]

# --------------------------- logical axes -----------------------------------
# Plain strings, the JAX package's own: specs compare by value across the
# two packages.

BATCH = "batch"          # global batch (data parallel)
SEQ = "seq"              # generic sequence axis
ATTN_SEQ = "attn_seq"    # sequence inside attention (context parallel)
ACT_SEQ = "act_seq"      # inter-block residual stream (sequence parallel)
EMBED = "embed"          # d_model; kept replicated (residual stream)
MLP = "mlp"              # feed-forward hidden (tensor parallel)
HEADS = "heads"          # query heads (tensor parallel)
HEAD = HEADS             # alias
KV_HEADS = "kv_heads"    # key/value heads (GQA may not divide)
HEAD_DIM = "head_dim"
VOCAB = "vocab"          # (padded) vocabulary
EXPERT = "expert"        # MoE expert pool
EXPERT_MLP = "expert_mlp"  # per-expert hidden (when EXPERT can't shard)
INNER = "inner"          # SSM d_inner
STATE = "state"          # SSM state dim
LAYERS = "layers"        # stacked-layer leading dim (never sharded)
CACHE_KV = "cache_kv"    # KV-cache head axis
CACHE_HD = "cache_hd"    # KV-cache head_dim axis
STAGE = "stage"          # pipeline stage (dist.pipeline)
SLOT = "slot"            # serve decode-slot pool: data-parallel like BATCH
BLOCK = "kv_block"       # paged KV-cache physical-block axis

# Mesh axes batch-like logical axes map onto, outermost first.
_DATA_AXES = ("pod", "data")
_MODEL_AXIS = "model"
_STAGE_AXIS = "stage"

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per tensor
    dim, each ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dim split over several axes, outermost first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh: a ``DeviceMesh`` (its
    ``mesh_dim_names``), a name -> size mapping, or an object with a
    JAX-style ``shape`` mapping. ``None`` has no axes."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {str(k): int(v) for k, v in mesh.shape.items()}


def _size(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis -> mesh-axes table, bound to a mesh."""

    mesh: Any
    table: Dict[str, MeshAxes]

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        """Mesh axis (or axes tuple) a logical axis resolves to, or None."""
        if logical is None:
            return None
        return self.table.get(logical)

    def axis_size(self, logical: Optional[str]) -> int:
        """Number of shards the logical axis is split into (1 if unsharded)."""
        ax = self.mesh_axes(logical)
        if ax is None or self.mesh is None:
            return 1
        shape = mesh_shape(self.mesh)
        n = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            n *= shape[a]
        return n

    def spec(self, logical_spec, dims=None) -> PartitionSpec:
        """PartitionSpec for a tuple of logical axes (None = replicated).

        A mesh axis may appear at most once per spec; later duplicates
        are dropped. With ``dims`` (the operand shape), axes whose
        shard count does not divide the dimension are dropped too.
        """
        shape = mesh_shape(self.mesh)
        used = set()
        out = []
        for i, logical in enumerate(logical_spec):
            ax = self.mesh_axes(logical)
            if ax is None or self.mesh is None:
                out.append(None)
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a not in used and a in shape)
            if dims is not None:
                n = 1
                for a in axes:
                    n *= shape[a]
                if n == 0 or dims[i] % n != 0:
                    out.append(None)
                    continue
            if not axes:
                out.append(None)
                continue
            used.update(axes)
            out.append(axes[0] if len(axes) == 1 else axes)
        return PartitionSpec(*out)

    def sharding(self, logical_spec, mesh=None, dims=None) -> tuple:
        """The DTensor placements of a logical spec on ``mesh`` (default:
        the rules' mesh), one per mesh dim: ``Shard(d)`` where the spec
        puts that mesh axis on tensor dim ``d``, else ``Replicate()``
        (``()`` = fully replicated). A dim split over several axes gets
        ``Shard(d)`` on each, outermost first, which is the JAX order
        when the mesh lists its axes in that order (it does for
        ("pod", "data"))."""
        from torch.distributed.tensor import Replicate, Shard
        use = mesh if mesh is not None else self.mesh
        if use is None:
            raise ValueError("ShardingRules has no mesh; pass one explicitly")
        where = {}
        for d, entry in enumerate(self.spec(logical_spec, dims=dims)):
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in mesh_shape(use))


def _present(shape: Dict[str, int], axis: str) -> bool:
    return shape.get(axis, 1) > 1


def _divides(dim: int, size: int) -> bool:
    return dim > 0 and size > 0 and dim % size == 0


def resolve_rules(mesh, *, d_model: int = 0, n_heads: int = 0,
                  n_kv_heads: int = 0, head_dim: int = 0, d_ff: int = 0,
                  vocab: int = 0, n_experts: int = 0,
                  d_inner: int = 0) -> ShardingRules:
    """Bind logical axes to the mesh for one model's dimensions.

    - ``BATCH`` (and the serving ``SLOT``/``BLOCK``) spreads over every
      data-like axis present ("pod", "data").
    - Tensor-parallel axes (``MLP``/``VOCAB``/``HEADS``/``INNER``/...)
      bind to "model" only when the corresponding dimension divides the
      axis size.
    - ``EXPERT`` and ``EXPERT_MLP`` are mutually exclusive on "model":
      experts shard when the pool divides, otherwise the per-expert
      hidden width does.
    - ``SEQ``/``ATTN_SEQ``/``ACT_SEQ`` reuse "model" (checked against
      shapes at ``constrain`` time, not here).
    - ``STAGE`` binds to a "stage" axis when the mesh has one
      (``dist.pipeline``).
    """
    table: Dict[str, MeshAxes] = {a: None for a in (
        BATCH, SEQ, ATTN_SEQ, ACT_SEQ, EMBED, MLP, HEADS, KV_HEADS,
        HEAD_DIM, VOCAB, EXPERT, EXPERT_MLP, INNER, STATE, LAYERS,
        CACHE_KV, CACHE_HD, STAGE, SLOT, BLOCK)}
    if mesh is None:
        return ShardingRules(mesh=None, table=table)
    shape = mesh_shape(mesh)

    data = tuple(a for a in _DATA_AXES if _present(shape, a))
    if data:
        table[BATCH] = data if len(data) > 1 else data[0]
        table[SLOT] = table[BATCH]
        table[BLOCK] = table[BATCH]
    if _present(shape, _STAGE_AXIS):
        table[STAGE] = _STAGE_AXIS

    if _present(shape, _MODEL_AXIS):
        m = shape[_MODEL_AXIS]
        if _divides(d_ff, m):
            table[MLP] = _MODEL_AXIS
        if _divides(vocab, m):
            table[VOCAB] = _MODEL_AXIS
        if _divides(n_heads, m):
            table[HEADS] = _MODEL_AXIS
        if _divides(n_kv_heads, m):
            table[KV_HEADS] = _MODEL_AXIS
            table[CACHE_KV] = _MODEL_AXIS
        if _divides(d_inner, m):
            table[INNER] = _MODEL_AXIS
        if _divides(n_experts, m):
            table[EXPERT] = _MODEL_AXIS
        elif _divides(d_ff, m):
            table[EXPERT_MLP] = _MODEL_AXIS
        table[SEQ] = _MODEL_AXIS
        table[ATTN_SEQ] = _MODEL_AXIS
        table[ACT_SEQ] = _MODEL_AXIS
    return ShardingRules(mesh=mesh, table=table)


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor? Cheap, and imports nothing: no DTensor exists
    until ``torch.distributed.tensor`` is loaded (a second to import), so
    the single-device paths that call this never load it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x, rules: Optional[ShardingRules], logical_spec):
    """Redistribute a DTensor to a logical spec's placements; a no-op
    off a mesh.

    Returns ``x`` untouched for ``rules=None``, a mesh-less rules
    object, a mesh of size 1, or a plain tensor. Axes that do not
    divide the operand's dimension are dropped rather than producing
    uneven shards, as in the JAX package.
    """
    if rules is None or rules.mesh is None or _size(rules.mesh) == 1 \
            or not is_dtensor(x):
        return x
    return x.redistribute(rules.mesh, rules.sharding(
        logical_spec, dims=tuple(x.shape)))


# --------------------------- rows on their ranks -----------------------------
# The MoE block's routing and experts and the chunked cross entropy run on
# plain tensors, each rank on its own rows (DTensor has no strategy for the
# routing's ``searchsorted``, and its vocab-parallel gather of the label
# logits fails on (B, S, V) logits). ``split_rows`` and ``split_mean``
# hand them each rank's slices of their weights: where the model axis
# splits those (``EXPERT``, ``EXPERT_MLP``, ``VOCAB``), the ranks' parts
# are summed with explicit collectives inside autograd (Megatron's f and
# g); no weight is gathered.

# ``whole_gathers``/``whole_gather_bytes``: the weights that ``split_rows``
# or ``split_mean`` hand their function whole on a mesh of more than one
# rank (every rank holds all of it, as a gather would leave it), and their
# bytes; 0 where the mesh splits every weight, the weights' count where
# the rules bind none of their axes. In serving, the weights that the
# rules split over ``model`` and a rank holds whole (``serve_slices``).
# ``split_all_reduces``: the all-reduces over the dims
# that split the weights (forward and backward, each mesh dim one; in
# serving each sum of the ranks' parts, and each norm's sum of squares over
# a split width). ``vocab_gathers``: the serving
# logits gathered over the model axis.
COUNTS = {"whole_gathers": 0, "whole_gather_bytes": 0,
          "split_all_reduces": 0, "vocab_gathers": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _row_layout(rows, keep=()):
    """(mesh, the rows' layout as they came, the layout they run in, the
    partial layout of a sum over them): the rows keep the first one's
    splits of dim 0, except over the mesh dims in ``keep``, which
    replicate them, and are split further over every other mesh dim
    that divides what is left of them, so that no two ranks with the same
    ``keep`` coordinates run the same rows. A sum over the rows is
    partial over the dims that split them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = rows[0].device_mesh
    came = [p if p.is_shard(0) else Replicate() for p in rows[0].placements]
    layout = [Replicate() if i in keep else p for i, p in enumerate(came)]
    n = rows[0].shape[0]         # rows a rank holds; 0: split unevenly
    for i, p in enumerate(layout):
        if p.is_shard(0):
            n = n // mesh.size(i) if n % mesh.size(i) == 0 else 0
    for i, p in enumerate(layout):
        if i not in keep and not p.is_shard(0) and mesh.size(i) > 1 \
                and n and n % mesh.size(i) == 0:
            layout[i] = Shard(0)
            n //= mesh.size(i)
    summed = [Partial() if p.is_shard(0) else Replicate() for p in layout]
    return mesh, came, layout, summed


def _local(rows, mesh, layout):
    return [r.redistribute(mesh, layout).to_local(grad_placements=layout)
            for r in rows]


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """What a function under ``split_rows``/``split_mean`` knows of the
    mesh dims that split its weights: their process groups (none: the
    weights are whole) and, for each weight, where its local slice starts
    in each of its dims (none: at 0)."""

    groups: tuple = ()
    offsets: tuple = ()

    def offset(self, i: int, dim: int) -> int:
        """Where weight ``i``'s local slice starts in its dim ``dim``."""
        return self.offsets[i][dim] if self.offsets else 0

    def all_reduce(self, t, op: str = "sum"):
        """``t`` summed (``op="max"``: its maximum) over the ranks that
        split the weights, in place; ``t`` itself where none do."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for g in self.groups:
            COUNTS["split_all_reduces"] += 1
            dist.all_reduce(t, op=red, group=g)
        return t


NO_SPLIT = ModelSplit()


class _FromRows(torch.autograd.Function):
    """Megatron's f: ``x`` as it is; its cotangent, a partial sum over
    the ranks that split the weights, summed in the backward."""

    @staticmethod
    def forward(ctx, split, x):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.split.all_reduce(g.contiguous().clone())


class _SumParts(torch.autograd.Function):
    """Megatron's g: the ranks' partial results summed; the cotangent,
    whole on every rank, passes on as it is."""

    @staticmethod
    def forward(ctx, split, x):
        return split.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return None, g


def local_offset(x, dim: int) -> int:
    """Where this rank's slice of a DTensor starts in its dim ``dim`` (0
    for a plain tensor). Shards split evenly, outermost mesh dim first,
    as DTensor's own layout does."""
    if not is_dtensor(x):
        return 0
    mesh, off, n = x.device_mesh, 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n //= mesh.size(i)
            off += mesh.get_local_rank(i) * n
    return off


def _split(mesh, weights):
    """(the mesh dims that split any of the weights, their
    ``ModelSplit``)."""
    dims = sorted({i for w in weights if is_dtensor(w)
                   for i, p in enumerate(w.placements) if p.is_shard()})
    if not dims:
        return dims, NO_SPLIT
    return dims, ModelSplit(
        groups=tuple(mesh.get_group(i) for i in dims),
        offsets=tuple(tuple(local_offset(w, d) for d in range(w.dim()))
                      for w in weights))


def _slices(weights, mesh, dims, summed):
    """Each weight's local slice; its gradient keeps the weight's splits
    and is partial over the dims that split the rows, and over the split
    dims where this weight is whole (each rank's part of it). A weight
    whole on a mesh of more than one rank is counted in ``COUNTS``."""
    from torch.distributed.tensor import Partial
    out = []
    for w in weights:
        if is_dtensor(w):
            grad = [p if p.is_shard() else Partial() if i in dims
                    else summed[i] for i, p in enumerate(w.placements)]
            local = w.to_local(grad_placements=grad)
        else:
            local = w
        if mesh.size() > 1 and local.shape == w.shape:
            COUNTS["whole_gathers"] += 1
            COUNTS["whole_gather_bytes"] += w.numel() * w.element_size()
        out.append(local)
    return out


def split_rows(fn, rows, weights):
    """``fn(split, *rows, *weights)`` on this rank's rows and its slices
    of the weights, where ``fn`` returns this rank's part of a sum (a
    tensor whose dim 0 is the rows').

    Off a mesh that is ``fn(NO_SPLIT, ...)`` on the tensors as they are.
    On a mesh the ``rows`` (DTensors with the batch on dim 0) keep their
    data splits and are replicated over the mesh dims that split the
    weights (``_row_layout(keep=)``), and split over every other mesh dim
    that divides them; ``fn`` runs on plain tensors, each rank on its own
    slices (``split.offset`` says where they start); the parts are summed
    over the dims that split the weights (one all-reduce each,
    ``_SumParts``), and the rows' cotangents, partial there too, likewise
    in the backward (``_FromRows``); the result comes back laid out as
    the rows came. The weights' gradients stay split. The MoE block's
    experts run so: ``EXPERT`` gives each rank its experts' rows,
    ``EXPERT_MLP`` its columns of every expert's hidden width; with
    neither bound the weights are whole and the groups split over the
    model axis too."""
    if not is_dtensor(rows[0]):
        return fn(NO_SPLIT, *rows, *weights)
    from torch.distributed.tensor import DTensor
    mesh = rows[0].device_mesh
    dims, split = _split(mesh, weights)
    mesh, came, layout, summed = _row_layout(rows, keep=dims)
    local = _local(rows, mesh, layout)
    if split.groups:
        local = [_FromRows.apply(split, t) if t.requires_grad else t
                 for t in local]
    out = fn(split, *local, *_slices(weights, mesh, dims, summed))
    if split.groups:
        out = _SumParts.apply(split, out)
    shape = torch.Size((rows[0].shape[0],) + tuple(out.shape[1:]))
    out = DTensor.from_local(out, mesh, layout, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return out.redistribute(mesh, came)


def split_mean(fn, rows, weights):
    """``sum / count`` over the global batch, where ``fn(split, *rows,
    *weights)`` returns this rank's (sum, count) in plain tensors, each
    whole over the mesh dims that split the weights: ``fn`` issues its
    own collectives over ``split.groups``, forward and backward.

    Off a mesh that is ``fn(NO_SPLIT, ...)`` on the tensors as they are.
    On a mesh the rows are laid out as in ``split_rows``, each rank
    passes its weight slices, and the sums of the ranks along the dims
    that split the rows are added (an all-reduce, differentiable). The
    chunked cross entropy runs so; where ``VOCAB`` splits the
    unembedding its rows are replicated over the model axis."""
    if not is_dtensor(rows[0]):
        s, c = fn(NO_SPLIT, *rows, *weights)
        return s / torch.clamp(c, min=1.0)
    from torch.distributed.tensor import DTensor
    mesh = rows[0].device_mesh
    dims, split = _split(mesh, weights)
    mesh, _, layout, summed = _row_layout(rows, keep=dims)
    s, c = (DTensor.from_local(t, mesh, summed, run_check=False)
            for t in fn(split, *_local(rows, mesh, layout),
                        *_slices(weights, mesh, dims, summed)))
    return s / torch.clamp(c, min=1.0)


def local_heads(fn, q, *kv):
    """``fn(q, *kv)`` on this rank's batch rows and heads.

    Off a mesh that is ``fn`` as it is. On a mesh (DTensors laid out
    (batch, seq, heads, head_dim)) the inputs keep q's batch split, take
    the heads split over every other mesh dim whose size divides all
    their head counts (GQA's groups stay whole) and are replicated over
    the rest; ``fn`` runs on the local tensors and its output (q's shape)
    comes back with that layout (split by heads where q came so). The
    model's chunked attention runs so: DTensor's propagation through its
    blockwise online softmax leaves the gradients in layouts that the
    projections' backward cannot reshape."""
    if not is_dtensor(q):
        return fn(q, *kv)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, xs = q.device_mesh, (q, *kv)
    head_dim = 2
    layout, heads = [], False
    for i, p in enumerate(q.placements):
        if p.is_shard(0):
            layout.append(p)
        elif not heads and all(x.shape[head_dim] % mesh.size(i) == 0
                               for x in xs):
            layout.append(Shard(head_dim))
            heads = True
        else:
            layout.append(Replicate())
    # Where q came split by heads and the K/V heads could not follow,
    # the output leaves split as q came, contiguous (DTensor would split
    # a replicated output itself for the output projection, as a strided
    # view that the matmul's flattening view cannot take); each rank's
    # inputs then get the gradient of its heads only, a partial sum,
    # brought back to each input's own layout.
    split = [i for i, p in enumerate(q.placements)
             if p.is_shard(head_dim) and layout[i].is_replicate()]
    grads = [Partial() if i in split else p for i, p in enumerate(layout)]
    out = fn(*[keep_grad_layout(x).redistribute(mesh, layout).to_local(
        grad_placements=grads) for x in xs])
    for i in split:
        out = out.chunk(mesh.size(i), dim=head_dim)[
            mesh.get_local_rank(i)].contiguous()
        layout[i] = Shard(head_dim)
    return DTensor.from_local(out, mesh, layout, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


class _KeepGradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's cotangent is replicated
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def keep_grad_layout(x):
    """``x``, whose gradient arrives in ``x``'s own layout (a DTensor's
    placements); anything else as it is. DTensor turns a partial sum in
    the backward into whatever layout is cheapest at that op, which can
    split the rows of a (B, S, D) gradient over two mesh axes, and the
    (B*S, D) -> (B, S, D) view in a matmul's backward has no strategy
    for that. The model's sublayer outputs pass through this."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _KeepGradLayout.apply(x)


# --------------------------- serving on the model axis -----------------------
# Serving runs the model on plain tensors, each rank on its slices of the
# weights and of the K/V cache (Megatron's layout, as the JAX package's
# GSPMD places them): the query heads and the K/V heads where ``HEADS`` and
# ``KV_HEADS`` bind, the MLP's hidden columns (``MLP``), the experts or their
# hidden columns (``EXPERT``, ``EXPERT_MLP``) and the vocabulary
# (``VOCAB``), the SSM mixers' channels (``INNER``) and the state and cross
# K/V that go with them. A sublayer whose contraction runs over a split
# dim leaves each rank a part of the sum, which one all-reduce over the
# model axis completes; a norm over a split width adds the ranks' sums of
# squares likewise; the embedding lookup is masked to the rank's rows and
# summed, and the logits' columns are gathered, so that sampling sees
# whole logits, the same bits on every rank.


def _model_dim(rules: ShardingRules, axes, dims) -> Optional[int]:
    """The dim of a leaf (logical ``axes``, whole shape ``dims``) that
    the rules bind to the model axis, or None."""
    for d, entry in enumerate(rules.spec(axes, dims=dims)):
        if entry == _MODEL_AXIS or (isinstance(entry, tuple)
                                    and _MODEL_AXIS in entry):
            return d
    return None


@dataclasses.dataclass(frozen=True, eq=False)
class ServeSplit:
    """The serving counterpart of ``ModelSplit``: what a model running on
    one rank's plain slices knows of the mesh's model axis. ``group`` is
    the process group over ``model`` (None off a model axis), ``size`` and
    ``rank`` this rank's place on it, and ``offsets`` the parameter tree
    with each leaf's offsets (where its local slice starts in each dim; in
    the model dim of a leaf cut by its parts, where each of the rank's
    pieces starts in the whole leaf).
    A model run on whole weights gets ``WHOLE``, whose every method is the
    identity."""

    group: Any = None
    size: int = 1
    rank: int = 0
    offsets: Any = None

    def offset(self, local: int, whole: int) -> int:
        """Where this rank's slice of a dim of ``whole`` entries starts,
        given that it holds ``local`` of them (0 where it holds all)."""
        if local == whole:
            return 0
        if local * self.size != whole:
            raise ValueError(f"a slice of {local} of {whole} entries does "
                             f"not split evenly over a model axis of "
                             f"{self.size}")
        return self.rank * local

    def sum_parts(self, t, parts: bool):
        """``t``, where ``parts``, a rank's part of a sum over a split
        dim, summed over the model axis (one all-reduce, in place on a
        contiguous ``t``); else ``t`` itself."""
        if not parts:
            return t
        if self.group is None:
            raise ValueError("a part of a sum over a split weight needs "
                             "the model group (sharding.serve_slices)")
        COUNTS["split_all_reduces"] += 1
        return self._all_reduce(t.contiguous())

    def rms_norm(self, x, weight, width: int, eps: float = 1e-6):
        """``layers.rms_norm`` of rows of ``width`` entries of which the
        rank holds ``x``'s last dim (and the same entries of ``weight``):
        each rank's sum of squares, added over the model axis (one
        all-reduce), gives the mean over the whole width. Whole rows
        take the mean as ``layers.rms_norm`` does."""
        dt = x.dtype
        x = x.float()
        if x.shape[-1] == width:
            ms = torch.mean(x * x, dim=-1, keepdim=True)
        else:
            self.offset(x.shape[-1], width)
            ms = self.sum_parts((x * x).sum(dim=-1, keepdim=True),
                                True) / width
        x = x * torch.rsqrt(ms + eps)
        if weight is not None:
            x = x * weight.float()
        return x.to(dt)

    def embed(self, table, tokens, vocab: int):
        """``table[tokens]`` for an embedding of ``vocab`` rows of which
        the rank holds ``table`` (rows ``[off, off + Vp/m)`` under
        ``VOCAB``): the lookup masked to its rows, then summed over the
        model axis (each token's row is nonzero on one rank only, so the
        sum is exact)."""
        n = table.shape[0]
        if n == vocab:
            return table[tokens]
        local = tokens.long() - self.offset(n, vocab)
        mine = (local >= 0) & (local < n)
        x = torch.where(mine[..., None], table[local.clamp(0, n - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        return self.sum_parts(x, True)

    def gather_vocab(self, logits, vocab: int):
        """Logits ``(..., Vp/m)`` of the rank's vocabulary columns as the
        whole ``(..., vocab)``, gathered over the model axis in rank
        order (the functional all-gather, which ``launch.distributed``
        stages through host memory under gloo on CUDA tensors); whole
        logits as they are."""
        n = logits.shape[-1]
        if n == vocab:
            return logits
        self.offset(n, vocab)
        COUNTS["vocab_gathers"] += 1
        got = self._all_gather(logits.reshape(-1, n).T.contiguous())
        return got.T.reshape(logits.shape[:-1] + (vocab,)).contiguous()

    # the two collectives, over the model group
    def _all_reduce(self, t):
        """``t`` summed over the ranks, in place."""
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        return t

    def _all_gather(self, t):
        """The ranks' ``t`` (n, rows) stacked in rank order (size * n,
        rows)."""
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.all_gather_into_tensor(
            t, self.size, self.group.group_name))


WHOLE = ServeSplit()


def serve_slices(params: Any, axes: Any, rules: ShardingRules, mesh,
                 parts: Optional[Mapping[str, tuple]] = None):
    """``(local, split)``: this rank's slices of a parameter tree for
    serving on ``mesh``'s model axis, as plain tensors, and their
    ``ServeSplit``. Each leaf keeps the dim that the rules bind to
    ``model`` (``axes``: ``model_zoo.param_axes``) cut to the rank's
    slice and every other dim whole.

    ``parts`` (``model_zoo.serve_parts``) names the leaves that
    concatenate several tensors along that dim (a mixer's input
    projection and conv), by their path (``"layers/ssm/in_proj"``), each
    as its parts ``((width, split), ...)`` in order: each part that
    splits is cut on its own and the others stay whole, so that the
    rank's leaf is the concatenation of its parts' slices (a contiguous
    cut of the whole would give one rank all of one part). A part that
    splits must divide the axis: cutting it unevenly would split a head,
    and that raises and names the rule.

    Nothing is gathered. A DTensor leaf gives its local tensor: placed by
    the rules it already is the slice; replicated over ``model`` it is
    whole here and the slice is cut from it. A plain leaf (every rank
    holds it whole) is cut likewise. A leaf placed any other way (split
    over another axis, or over another dim than the rule's, or a leaf of
    parts split contiguously) cannot be had without a gather: that
    raises and names the rule. ``COUNTS["whole_gathers"]`` counts the
    leaves that the rules split but that a rank would still hold whole
    (none here). On a mesh without a model axis every leaf is whole and
    the split is ``WHOLE``'s."""
    names = list(mesh.mesh_dim_names)
    if _MODEL_AXIS not in names:
        dm, m, rank = None, 1, 0
    else:
        dm = names.index(_MODEL_AXIS)
        m, rank = mesh.size(dm), mesh.get_local_rank(dm)
    parts = parts or {}

    def one(t, ax, path):
        whole = tuple(t.shape)
        cut_by = parts.get(path)
        # a leaf of parts binds by its rule: its parts are checked below
        d = _model_dim(rules, ax, None if cut_by else whole)
        if is_dtensor(t):
            for i, p in enumerate(t.placements):
                if (i == dm and p.is_shard() and (p.dim != d or cut_by)) \
                        or (i != dm and not p.is_replicate()):
                    raise ValueError(
                        f"{path}: placed {p} over mesh axis {names[i]!r}; "
                        f"serving holds a rank's slice under the rule "
                        f"{ax} -> {rules.spec(ax, dims=whole)}, which only "
                        f"a gather could make of it")
            cut = dm is None or not t.placements[dm].is_shard()
            t = t.to_local()
        else:
            cut = True
        if d is not None and cut and cut_by:
            widths = [w for w, _ in cut_by]
            if sum(widths) != whole[d]:
                raise ValueError(f"{path}: parts {cut_by} do not add up to "
                                 f"its dim {d} of {whole[d]}")
            for w, split in cut_by:
                if split and w % m:
                    raise ValueError(
                        f"{path}: a part of {w} entries does not split over "
                        f"the model axis of {m} under the rule {ax} -> "
                        f"{rules.spec(ax)}; cutting it would split a head")
            pieces = torch.split(t, widths, dim=d)
            t = torch.cat([p.chunk(m, dim=d)[rank] if split else p
                           for p, (_, split) in zip(pieces, cut_by)], dim=d)
            starts, at = [], 0
            for w, split in cut_by:
                starts.append(at + (rank * w // m if split else 0))
                at += w
            return t.contiguous(), tuple(
                tuple(starts) if i == d else 0 for i in range(t.dim()))
        if d is not None and cut:
            # a copy: a view would keep the whole tensor's storage alive
            t = t.chunk(m, dim=d)[rank].clone(
                memory_format=torch.contiguous_format)
        local = t.contiguous()
        if d is not None and local.shape[d] == whole[d]:
            COUNTS["whole_gathers"] += 1
            COUNTS["whole_gather_bytes"] += local.numel() * local.element_size()
        return local, tuple(rank * local.shape[i] if i == d else 0
                            for i in range(local.dim()))

    def walk(t, ax, path):
        if isinstance(t, dict):
            got = {k: walk(v, ax[k], f"{path}/{k}") for k, v in t.items()}
            return ({k: v[0] for k, v in got.items()},
                    {k: v[1] for k, v in got.items()})
        return one(t, ax, path.lstrip("/"))

    local, offsets = walk(params, axes, "")
    if dm is None:
        return local, WHOLE
    return local, ServeSplit(group=mesh.get_group(dm), size=m, rank=rank,
                             offsets=offsets)


def logical_to_sharding(axes: Any, rules: ShardingRules,
                        mesh=None) -> Any:
    """Map a tree of logical-axis tuples (``model_zoo.param_axes``) to
    placements on ``mesh`` (default: the rules' mesh). Tuples are
    leaves."""
    return pytree.tree_map(lambda spec: rules.sharding(spec, mesh=mesh),
                           axes, is_leaf=lambda s: isinstance(s, tuple))


def distribute_local(x: torch.Tensor, mesh, placements):
    """``x``, which every rank holds whole and alike, as a DTensor on
    ``mesh`` with ``placements``: each rank keeps its own slice, with no
    communication (``distribute_tensor`` would broadcast along every
    replicated mesh dim). Shards split evenly, in mesh-dim order, as
    DTensor's own layout does."""
    from torch.distributed.tensor import DTensor
    local = x
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does "
                                 f"not split evenly over {n} ranks")
            local = local.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, list(placements),
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def distribute_tree(tree: Any, placements: Any, mesh) -> Any:
    """Every tensor of a dict tree as a DTensor on ``mesh`` with the
    placements at the same place of ``placements`` (a tree from
    ``logical_to_sharding``): the port's ``jax.device_put(params,
    shardings)``. Every rank passes the same full tensors."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, placements[k], mesh)
                for k, v in tree.items()}
    return distribute_local(tree, mesh, placements)


# --------------------------- mesh slices ------------------------------------
# Disaggregated serving carves one fleet into disjoint submeshes, a
# prefill slice and a decode slice, and ships finished KV blocks between
# them. In the port a fleet is the ranks of the default process group.


def carve_slices(n_first: int, devices=None):
    """Split a device (rank) list into two disjoint contiguous slices:
    ``(first, rest)``, the leading ``n_first`` and the remainder.
    ``devices`` defaults to the ranks of the default process group (one
    rank when none is initialised)."""
    if devices is None:
        n = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
        devices = range(n)
    devices = list(devices)
    if not 0 < n_first < len(devices):
        raise ValueError(
            f"carve_slices(n_first={n_first}) needs 0 < n_first < "
            f"{len(devices)} devices (both slices must be non-empty)")
    return devices[:n_first], devices[n_first:]


def slice_mesh(devices, axes=("data",), shape=None, device_type=None):
    """A ``DeviceMesh`` over an explicit subset of ranks, reshaped to
    ``shape`` (default: 1-D over one axis). Every rank of the default
    group calls it, as it builds process groups; a rank outside the
    slice gets a mesh it is not part of (``get_coordinate()`` is None).
    ``device_type`` defaults to "cuda" when a card is present."""
    from torch.distributed.device_mesh import DeviceMesh
    devices = [int(d) for d in devices]
    axes = tuple(axes)
    shape = (len(devices),) if shape is None else tuple(shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} / axes {axes} rank mismatch")
    n = 1
    for s in shape:
        n *= s
    if n != len(devices):
        raise ValueError(
            f"shape {shape} wants {n} devices, got {len(devices)}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.tensor(devices).reshape(shape),
                      mesh_dim_names=axes)


def transfer_sharding(rules: ShardingRules, mesh, dims) -> tuple:
    """Destination placements of a shipped KV-block buffer
    ``(L, R, n_cols, block, KV, hd)`` (``PagedKVCache.export_rows``): the
    destination pool's head axes (``CACHE_KV``/``CACHE_HD``), the row and
    column dims replicated; on a data-only slice every axis drops."""
    return rules.sharding((LAYERS, None, None, None, CACHE_KV, CACHE_HD),
                          mesh, dims=tuple(dims))


# --------------------------- a sharded pool's host view ----------------------
# A serving pool sharded over the data axes (``serve/scheduler.py``) runs
# its host logic on every rank alike, on the whole pool; each rank holds
# and computes its own shard. What the host reads comes from all shards,
# gathered in one collective, in the same order on every rank.


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a mesh and one DTensor
    placement per mesh dim (``ShardingRules.sharding``'s tuple)."""

    mesh: Any
    placements: tuple


def named_shardings(placements: Any, mesh) -> Any:
    """A tree of placement tuples (``logical_to_sharding``) as a tree of
    ``NamedSharding`` on ``mesh``; ``None`` leaves stay ``None``."""
    if isinstance(placements, dict):
        return {k: named_shardings(v, mesh) for k, v in placements.items()}
    if isinstance(placements, tuple) and hasattr(placements, "_fields"):
        return type(placements)(*(named_shardings(getattr(placements, n),
                                                  mesh)
                                  for n in placements._fields))
    return None if placements is None else NamedSharding(mesh,
                                                         tuple(placements))


def data_axes(rules: ShardingRules) -> Tuple[str, ...]:
    """The mesh axes the serving ``SLOT``/``BLOCK`` axes bind to
    (outermost first; empty off a mesh)."""
    ax = rules.mesh_axes(SLOT) if rules is not None else None
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def data_index(mesh, axes, coord=None) -> int:
    """The linear index over ``axes`` (outermost first) of a mesh
    coordinate (default: this rank's), which is the order in which DTensor
    lays out a dim split over those axes."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate() if coord is None else coord
    r = 0
    for a in axes:
        d = names.index(a)
        r = r * mesh.size(d) + int(coord[d])
    return r


def gather_objects(mesh, obj) -> Any:
    """Every rank's ``obj``, gathered over ``mesh``: nested lists indexed
    by mesh coordinate (``out[i0][i1]...``). One ``all_gather_object`` a
    mesh dim, over the groups the mesh already holds, so only the mesh's
    own ranks take part (a slice of a larger fleet gathers alone)."""
    import torch.distributed as dist
    out = obj
    for d in reversed(range(mesh.ndim)):
        got = [None] * mesh.size(d)
        dist.all_gather_object(got, out, group=mesh.get_group(d))
        out = got
    return out


def gather_shards(mesh, axes, obj) -> list:
    """Each data shard's ``obj`` (the ranks whose coordinate on ``axes``
    has that linear index and whose other coordinates are this rank's),
    in shard order: the replicated host view of a pool sharded over the
    data axes. Every rank of the mesh calls it, in the same order."""
    import itertools
    full = gather_objects(mesh, obj)
    names = list(mesh.mesh_dim_names)
    mine = mesh.get_coordinate()
    sizes = [mesh.size(names.index(a)) for a in axes]
    out = []
    for idx in itertools.product(*(range(s) for s in sizes)):
        coord = list(mine)
        for a, i in zip(axes, idx):
            coord[names.index(a)] = i
        v = full
        for c in coord:
            v = v[c]
        out.append(v)
    return out


def shard_leader(mesh, axes, shard: int) -> int:
    """The global rank that speaks for data shard ``shard``: the lowest
    rank among those holding it (its replicas over the other axes hold
    the same values)."""
    ranks = mesh.mesh.reshape(-1).tolist()
    coords = [[int(c) for c in torch.nonzero(mesh.mesh == r)[0].tolist()]
              for r in ranks]
    return min(r for r, c in zip(ranks, coords)
               if data_index(mesh, axes, c) == shard)
