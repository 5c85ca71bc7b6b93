"""Slot-based continuous-batching decode scheduler: one-shot or
chunked admission.

Port of ``repro/serve/scheduler.py`` (admission, the decode segment,
harvest). The engine owns a fixed pool of ``n_slots`` decode slots,
each one row of a shared cache (attention K/V, a pure-SSM model's
conv and h state, or both for the hybrid) plus per-slot registers on
the device (``cur_len``, ``n_emitted``, ``budget``, ``active``, ``done``
...).

Two admission modes:

- ``prefill="oneshot"`` (the default, as in the JAX package): FREE ->
  RUNNING in one admission call, which prefills every admitted prompt
  in ONE ``engine.prefill`` over the ``n_slots``-wide permuted batch
  and samples each first token at the row's last real position. Dense,
  VLM and audio prompts are right-padded to a power-of-two bucket; SSM,
  hybrid and MoE prompts must be exactly ``prompt_len`` long (a
  recurrence keeps folding pad lanes into its state, and pad tokens
  would displace real ones from expert slots). SSM state comes back
  fresh from the prefill and is spliced into the pool along the slot
  axis; the hybrid's prefill also writes its prompt K/V into every
  application's cache layer through the block table, and it admits
  one-shot only. So does the audio family: every request brings its
  frame embeddings (``submit(frames=)``), the admission runs the
  encoder over them, and the cross K/V it returns fresh splices into
  the pool's ``cross`` cache along the slot axis, with the device's
  tensors only (rows without a request get zero frames).
- ``prefill="chunked"`` (dense, MoE and VLM families): FREE -> PREFILLING
  (assigned at admission: registers and block tables, no model forward)
  -> RUNNING. Every iteration of a segment advances each prefilling slot
  by at most ``chunk_tokens`` prompt positions (``engine.prefill_chunk``,
  through the flash-prefill kernel when the cache is paged and
  ``cfg.attn_impl == "cuda"``); a slot whose chunk covers its last
  prompt position samples its first token and decodes in the same
  iteration.

A VLM pool (``prefix_len = cfg.n_patches``) takes each request's patch
embeddings (``submit(prefix_embeds=)``): they fill stream positions
``[0, prefix_len)`` ahead of the tokens, in the one-shot prefill or from
the pool's ``prefix`` register chunk by chunk, and the prefix index
seeds each request's chain hash with a digest of its embeds, so that
requests with one image share its blocks and distinct images never do.

MoE decode routes all ``n_slots`` rows as ONE group (``models.moe``),
free and mid-prefill rows included, so a request's tokens depend on what
the other rows feed; every row is fed what the JAX package feeds it (a
retired slot its frozen token, a prefilling one the zero its admission
wrote), in both lowerings.

In both modes each iteration decodes every running slot one token
(``engine.decode_step``, through the paged-attention kernel for a paged
cache under ``attn_impl="cuda"``), and a slot retires to DONE on EOS or
its budget (its cache blocks freed on the device) until the host
harvests it.

Sampling. Each request carries a threefry key, ``fold_in(PRNGKey(seed),
request_id)`` derived on the device at admission unless ``submit`` is
given one; the token at emission index j draws from ``fold_in(key, j)``
(``sampling.step_keys``), so a sampled stream depends on the request's
key and logits only, not on its slot or the pool's size, and equals the
JAX package's for the same key.

Speculation (``speculative=SpecConfig(k=...)``, chunked mode only): the
decode branch becomes the JAX package's ``spec_decode_fn``. Each running
slot drafts k tokens (``speculative.draft_ngram`` over its prompt and
emissions, or k+1 greedy ``decode_step``s of a draft model against its
own dense cache, a pool register that ``_chunk`` also prefills), ONE
``engine.verify_step`` scores the window ``[pending, d_1..d_k]``
(through the chunk kernel's ``flash_verify`` entry on a paged cache
under ``attn_impl="cuda"``), ``speculative.accept`` takes a prefix, and
up to ``accepted + 1`` tokens are emitted, cut at the first EOS and the
budget; a slot that finishes retires and frees its blocks in the same
iteration. Greedy speculative streams equal the non-speculative ones.

Adaptive depth (``cfg.early_exit``, ``cfg.mod_capacity``;
``models.adaptive``). The decode passes ``live`` = the emitting rows that
do not retire in this iteration, so retired, retiring and prefilling
slots start the early-exit layer loop halted, and adds the depth of
each decode whose token will be emitted to the slot's
``slot_layers``/``slot_decodes`` (restarted at admission; a request of
n tokens counts n - 1 decodes, the first token being the prefill's); the harvest's one read brings them, and
``FinishedRequest.mean_depth``, ``mean_depth`` and ``slot_mean_depth``
come from it. Inside the captured segment the layer loop is an IF node a
layer (``transformer.decode_layers``); ``depth_impl`` names the
lowering. A draft model with early exit drafts at adaptive depth; the
verify stays at full depth.

A segment is the JAX package's ``step``: one ``core.while_loop`` that
runs while some slot is busy, fewer than ``want`` slots are idle and
fewer than ``max_steps`` iterations have run (its ``cond_fn``). Its body
is, in chunked mode, ``cond(any(prefilling), chunk)`` then
``cond(any(active), decode)`` (a slot that finishes its chunk decodes in
the same iteration), and in one-shot mode the decode alone; then
``steps += 1``. Two lowerings (``loop_impl``):

- ``"cuda-graph:while"`` (the default on a CUDA pool): the loop is
  captured once (``warmup``) as a ``core.device_loop.DeviceLoop``, the
  lowering of ``core.while_loop(impl="graph")``: a CUDA graph whose
  WHILE node evaluates the predicate and whose IF nodes
  (``cond(backend="graph")``) take the two branches on the device. The scheduler holds the loop and
  frees it in ``close()``. A segment is one H2D write of
  ``want``/``max_steps``, one graph launch, and one host read at harvest
  (``done``, the emissions and the device counters in one transfer).
  Everything the body writes is written in place, so the captured
  addresses stay valid; admission stays eager between segments, as in
  the JAX package.
- ``"host-read"`` (the only one on the CPU; on the card only when asked
  for with ``loop="host"``): the same predicate (``_seg_cond``) and
  branches, decided on the host from ONE read per iteration of the
  predicate and the two branch decisions.

The counters (loop iterations, decoding slot-iterations, iterations that
ran each branch, kernel launches) live on the device, as the JAX
package's ``steps`` and ``slot_steps`` do, and are read with the
harvest. A captured kernel call launches nothing when Python makes it,
so the graph counts each launch on the device where it happens
(``kernels.count_launch``), and the harvest advances the wrappers'
``launches`` counters (and ``PagedView.gather_calls``) by those counts.

Prefix cache (``prefix_cache=True``: chunked and paged only). A
host-side index (``_PrefixIndex``) keys every full prompt block by a
chain hash (blake2b over the previous key and the block's tokens, the
JAX package's keys), so a key match proves the whole prefix equal.
Admission plans first and commits after (``_admit_queued``): a request
maps the longest READY run of its blocks, capped at ``(plen - 1) //
block`` so that at least one position prefills in-row and every write
lands in a fresh block, evicting least-recently-used unreferenced entries
until its fresh blocks fit; its prefill then starts at ``pf_pos = hits x
block``, and the chunk kernel reads the shared blocks through the row's
table. Its other full blocks are registered PENDING, pinned by one extra
reference at ``alloc``, and turn READY once the row has left prefill.
The cache is created with ``sharing=True`` (``kv_cache`` module
docstring); without the prefix cache the segment captures no
copy-on-write at all.

Preemption (``preempt_slots``/``resubmit``, the SLO layer's mechanism):
victims' rows are freed through the refcounted ``free`` and their
registers returned to FREE in place between segments, and each request
re-queues for recompute-from-prompt (the same key, so the same stream).
READY registrations keep their pins (a replay maps them back); PENDING
ones are half-written and leave the index in the same call.

What the host needs between segments comes with the harvest's one read
(``_harvest``): besides ``done``, the emissions and the counters, which
slots still prefill (registrations turn READY), the block ids of the
blocks registered at admission (taken from a copy of the table written
at admission, which retirement does not clear), and ``reclaimable`` for
a paged pool (the SLO layer's victim order). ``host_reads`` counts every
read. Without the prefix cache every block has one reference and a
row's blocks are allocated whole, so admission, a splice and a
preemption keep ``reclaimable`` exact on the host and nothing else is
read. With the prefix cache, shared and pinned blocks make the host's
count inexact: a preemption or a ``reclaimable_host`` call made before
any segment has run since the last admission or preemption reads what
it needs then.

Disaggregation (``serve/disagg.py``) drives two schedulers on one card.
The prefill tier is built with ``prefill_only=True`` (chunked and
paged): a row whose prompt completes retires to DONE holding its blocks
and its first token instead of decoding, and its segment, a capture of
its own, holds no decode branch. ``dispatch_segment`` admits and
launches a segment without reading the device; ``harvest_prefilled``
brings ``done``, the first tokens and the prompt lengths with the
harvest's one read; ``release_slots`` frees the shipped rows. The
decode tier admits prefilled requests with ``splice_requests``: it
allocates, imports the shipped blocks (``PagedKVCache.import_rows``)
and registers each request RUNNING with ``cur_len = plen + 1``, the
state a colocated slot holds the moment its last chunk completes, in
one host-to-device write and no read.

The scheduler keeps the device and stream it was built on and makes
them current whenever it works (``step``, ``warmup``, ``preempt_slots``),
so a front-end may step it from a worker thread.

A mesh (``rules=`` and ``mesh=``, the JAX package's SPMD pool). The pool
is placed as ``pool_shardings`` says: slot registers, dense cache rows,
the SSM and cross state over ``SLOT``, a paged cache's block pools (and
``owner``/``refcount``) over ``BLOCK``, the table over ``SLOT``; both bind
to the data axes. ``sharded_pool`` holds those DTensors. On a mesh of
one device the pool is placed exactly as off a mesh. On a larger one:

- Each data shard (rank) holds a contiguous range of ``n_slots / D``
  slots and ``kv_blocks / D`` blocks, and its rows' tables point into its
  own blocks only, so the kernels and their plain versions read one
  rank's local tensors (``pool`` is this rank's shard; the DTensors of
  ``sharded_pool`` view the same storage). Each shard keeps its own
  trash row and block.
- Every rank runs the same host logic on the whole pool: admission
  places a request in the lowest free slot whose shard has room for its
  fresh blocks (the free-block mirror is per shard), and what the host
  reads (the harvest, the segment's flags, ``reclaimable``) is gathered
  from every shard in one collective (``sharding.gather_shards``), in
  the same order on every rank.
- The segment runs the host-read lowering (a CUDA graph cannot capture
  the collective each iteration needs), and ``loop_impl`` says so; each
  iteration's flags are the whole pool's, so every rank runs the same
  branches (a rank with no row in a branch runs it masked).
- A prefix-cache hit maps blocks of the admitting shard; a hit on
  another shard's block (and every hit after it in the run) is copied
  into a fresh block of the admitting shard at admission, and
  ``cross_rank_block_copies`` counts the cross-shard ones.
- The pool is replicated over the data axes (every rank runs every
  row) when they do not divide ``n_slots`` and ``kv_blocks``, and for
  the MoE family, whose decode routes every slot as one group.

A model axis (every family; ``model_layout`` is "split:modelx<m>").
Each rank keeps its slices of the weights as plain tensors
(``sharding.serve_slices``, which gathers nothing): the query and K/V
heads where ``HEADS`` and ``KV_HEADS`` bind, the MLP's hidden columns,
the experts' rows or hidden columns, the vocabulary's rows of the
embedding and columns of the unembedding, the mamba mixers' channels
where ``INNER`` binds (mamba1's Di/m, mamba2's H/m heads with the whole
B and C; a projection that concatenates several tensors is cut part by
part, ``model_zoo.serve_parts``), zamba2's shared block as the dense
path's, and whisper's heads and MLP columns in the encoder and decoder.
The pool is placed with ``CACHE_KV`` on ``model``: each rank's cache
holds its KV/m heads (all of them where the K/V heads do not divide the
axis, the query heads then being a range of them,
``transformer.head_range``), the audio family's cross K/V its KV/m heads
likewise, and the SSM state its channels on ``INNER``; the DTensor
views in ``sharded_pool`` are split over ``model`` there. Block ids,
tables, ``owner``, ``refcount`` and every slot register are the same
on the ranks of one data shard, which run the same host logic on the
same rows; only the heads and channels differ. Each sublayer's part is
summed over ``model`` (one all-reduce after ``wo``, one after the MLP's
or the experts' down projection, before a bias that is whole, one after
a mixer's ``out_proj`` and one on mamba1's ``x_proj`` product), a norm
over a split width adds the ranks' sums of squares (mamba2's gated
RMSNorm), the embedding lookup is masked to the rank's rows and summed
likewise, and the logits' columns are gathered, so that sampling and the
PRNG see whole logits, the same bits on every rank, and every rank emits
the same streams. A one-shot admission splices the rank's slices of the
fresh SSM state and cross K/V into its pool.

Per-request greedy outputs equal ``engine.generate_batch_sync``'s, and
are identical between ``kv="dense"`` and ``kv="paged"``, with the prefix
cache on and off, and on a mesh and off one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import core, kernels
from ..core import device_loop
from ..dist import sharding as sh
from ..kernels.flash_prefill import kernel as fp_kernel
from ..kernels.paged_attention import kernel as pa_kernel
from ..models import model_zoo, transformer
from . import engine, kv_cache as kvc
from . import prng
from . import sampling as sampling_lib
from . import speculative as spec_lib

# "no per-segment iteration cap" (the JAX package's _NO_STEP_CAP): large
# enough that the free-slot predicate always fires first
_NO_STEP_CAP = 2**31 - 1

# the calls a captured segment counts on the device (``SlotPool.launches``,
# in this order), and the Python-side counters the harvest advances
_COUNTED = ("paged_attention", "flash_prefill", "gather", "flash_verify")
_LAUNCH_COUNTERS = ((pa_kernel.paged_attention, "launches"),
                    (fp_kernel.flash_prefill, "launches"),
                    (kvc.PagedView, "gather_calls"),
                    (fp_kernel.flash_verify, "launches"))


@dataclasses.dataclass
class SlotPool:
    """Device-resident scheduler state, one entry per slot."""

    cache: Dict[str, Any]    # engine.make_cache(cfg, n_slots, max_len, ...)
    next_token: torch.Tensor  # (n,) int32 — token to feed the next step
    cur_len: torch.Tensor    # (n,) int32 — valid cache positions + 1
    n_emitted: torch.Tensor  # (n,) int32
    budget: torch.Tensor     # (n,) int32 — per-request max_new
    active: torch.Tensor     # (n,) bool — RUNNING
    done: torch.Tensor       # (n,) bool — retired, awaiting harvest
    request_id: torch.Tensor  # (n,) int32
    keys: torch.Tensor       # (n, 2) int64 — request keys (uint32 words)
    out: torch.Tensor        # (n, max_new_cap) int32 — emissions
    # chunked mode only (the prompt buffer is (n, 0) in one-shot mode)
    prompt: torch.Tensor     # (n, prompt_len) int32 — resident prompts
    plen: torch.Tensor       # (n,) int32 — true prompt length
    pf_pos: torch.Tensor     # (n,) int32 — prompt positions written
    prefilling: torch.Tensor  # (n,) bool
    prefix: torch.Tensor     # (n, prefix_len, d_model) — VLM patch embeds
    #                          (chunked mode; (n, 0, d_model) otherwise)
    # the draft model's own cache (speculation with drafter="model";
    # else {}): dense, rows are slots
    draft: Dict[str, Any]
    # device counters, read with the harvest
    steps: torch.Tensor      # () int32 — loop iterations
    slot_steps: torch.Tensor  # () int32 — decoding slots, summed over them
    chunk_steps: torch.Tensor  # () int32 — iterations that ran a chunk
    decode_steps: torch.Tensor  # () int32 — iterations that ran a decode
    launches: torch.Tensor   # (4,) int64 — graph launches of _COUNTED
    slot_accepted: torch.Tensor  # (n,) int32 — tokens emitted beyond one
    #                              a verify window, summed
    slot_windows: torch.Tensor   # (n,) int32 — verify windows run
    slot_layers: torch.Tensor    # (n,) int32 — decoder blocks applied to
    #                              the resident request's tokens, summed
    slot_decodes: torch.Tensor   # (n,) int32 — decode tokens that sum
    #                              covers (mean depth = layers / decodes)
    # the request's class (lower = more urgent) and deadline (host-clock
    # seconds, +inf: none), registered for the SLO layer
    priority: torch.Tensor   # (n,) int32
    deadline: torch.Tensor   # (n,) float32
    # the segment's arguments
    limits: torch.Tensor     # (2,) int32 — want, max_steps (host-written)
    seg_start: torch.Tensor  # () int32 — steps at segment entry


pytree.register_pytree_node(
    SlotPool,
    lambda p: ([getattr(p, f.name) for f in dataclasses.fields(p)], None),
    lambda leaves, _: SlotPool(*leaves))


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    tokens: np.ndarray       # (length,) — EOS included when hit
    length: int              # emitted tokens, EOS included
    text_length: int         # tokens before EOS
    hit_eos: bool
    mean_depth: float = 0.0  # decoder blocks applied a decode token
    #                          (< n_layers when adaptive depth skipped some)


@dataclasses.dataclass
class _Queued:
    request_id: int
    prompt: np.ndarray       # (1, L) int32, 1 <= L <= prompt_len
    max_new: int
    key: Optional[np.ndarray] = None  # (2,) uint32 words; None: derived
    priority: int = 0        # lower = more urgent (the SLO layer)
    deadline: float = float("inf")
    prefix_embeds: Optional[np.ndarray] = None  # (1, prefix_len, d): VLM
    frames: Optional[np.ndarray] = None  # (1, n_frames, d): audio


@dataclasses.dataclass
class PreemptedRequest:
    """A resident request evicted by ``preempt_slots``: what re-queues it
    for recompute-from-prompt, and the tokens it had emitted (a replay
    regenerates them bit for bit: the same key, keyed by emission
    index)."""

    request_id: int
    prompt: np.ndarray       # (1, L) int32: the original prompt
    max_new: int             # the original budget
    key: Optional[np.ndarray]  # the explicit key; None: derived from the id
    tokens: np.ndarray       # (n_emitted,) at preemption
    priority: int = 0
    deadline: float = float("inf")
    prefix_embeds: Optional[np.ndarray] = None  # a VLM request's patches
    frames: Optional[np.ndarray] = None         # an audio request's frames


# =========================== prefix index ===================================

@dataclasses.dataclass
class _PrefixEntry:
    """One cached full prompt block: its physical ``block_id`` (-1 until
    the harvest after the registering admission reads it), ``ready``
    once the registering slot has left prefill (only READY entries
    match: a half-written block is never shared), and ``row_refs``, the
    resident rows referencing it (the registering row included), so
    eviction never pulls a block from under a live table."""

    block_id: int = -1
    ready: bool = False
    row_refs: int = 0


class _PrefixIndex:
    """Host-side content-addressed index over READY prompt blocks, the
    JAX package's: chain-hash keys (block ``i``'s key digests block
    ``i-1``'s key and block ``i``'s token ids), so the two packages hit
    and evict the same blocks on the same traffic; entries in LRU order,
    eviction taking the least recently used READY entry with no resident
    reference."""

    def __init__(self, block: int):
        self.block = int(block)
        self.entries: "collections.OrderedDict[bytes, _PrefixEntry]" = \
            collections.OrderedDict()

    @staticmethod
    def seed(prefix_embeds) -> bytes:
        """Chain seed of a request: a digest of a VLM request's patch
        embeds (distinct images diverge at block 0), else empty."""
        if prefix_embeds is None:
            return b""
        return hashlib.blake2b(np.ascontiguousarray(
            np.asarray(prefix_embeds)).tobytes(), digest_size=16).digest()

    def hashes(self, tokens: np.ndarray, prefix_len: int,
               seed: bytes) -> List[bytes]:
        """Chain hash of every FULL stream block of a prompt (the stream
        is ``prefix_len`` patch positions, then the tokens)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        plen = prefix_len + len(tokens)
        h = hashlib.blake2b(seed, digest_size=16).digest()
        out = []
        for jb in range(plen // self.block):
            lo = max(0, jb * self.block - prefix_len)
            hi = (jb + 1) * self.block - prefix_len
            seg = tokens[lo:hi] if hi > 0 else tokens[:0]
            h = hashlib.blake2b(h + seg.tobytes(), digest_size=16).digest()
            out.append(h)
        return out

    def lookup(self, hs: List[bytes], cap: int, dead=frozenset()):
        """Longest READY prefix run of ``hs``, at most ``cap`` blocks,
        skipping keys in ``dead`` (planned for eviction this round).
        Pure: admission planning may back out. Returns (keys, ids)."""
        keys: List[bytes] = []
        ids: List[int] = []
        for h in hs[:cap]:
            e = self.entries.get(h)
            if e is None or not e.ready or e.block_id < 0 or h in dead:
                break
            keys.append(h)
            ids.append(e.block_id)
        return keys, ids

    def pick_victim(self, reserved, where=None) -> Optional[bytes]:
        """The LRU READY entry with no resident reference, not in
        ``reserved`` (and whose block ``where`` accepts: a sharded pool
        evicts in the admitting shard)."""
        for h, e in self.entries.items():
            if h in reserved or not e.ready or e.row_refs > 0 \
                    or e.block_id < 0 \
                    or (where is not None and not where(e.block_id)):
                continue
            return h
        return None

    def evict(self, h: bytes) -> int:
        """Drop an entry; returns its block id, whose pin the caller
        releases."""
        return self.entries.pop(h).block_id

    def register(self, h: bytes) -> _PrefixEntry:
        """Add a PENDING entry referenced by the registering row."""
        e = _PrefixEntry(row_refs=1)
        self.entries[h] = e
        return e

    def touch(self, h: bytes) -> None:
        self.entries.move_to_end(h)

    def __len__(self) -> int:
        return len(self.entries)


# =========================== shardings ======================================

# SlotPool fields that are per-rank counters and arguments, not slot state
_COUNTER_FIELDS = ("steps", "slot_steps", "chunk_steps", "decode_steps",
                   "launches", "limits", "seg_start")


def pool_shardings(cfg, n_slots: int, max_len: int, max_new_cap: int,
                   rules, mesh=None, *, kv: str = "dense",
                   kv_block: int = 16, kv_blocks: Optional[int] = None,
                   prompt_len: int = 0, prefix_len: int = 0,
                   draft_cfg=None) -> Dict[str, Any]:
    """DTensor placements of a ``SlotPool`` under ``rules``, one entry per
    slot-state field (the JAX package's ``pool_shardings``): per-slot
    registers, dense cache rows and the chunked-mode prompt buffers over
    ``SLOT``; a paged cache's block pool over ``BLOCK``
    (``PagedKVCache.shardings``). ``prompt_len``/``prefix_len`` size the
    chunked-prefill buffers (0 in a one-shot pool). Counts that do not
    divide fall back to replicated through the dims-aware spec. The
    caches are mirrored on the "meta" device, at no cost."""
    cache = engine.make_cache(cfg, n_slots, max_len, kv_impl=kv,
                              kv_block=kv_block, kv_blocks=kv_blocks,
                              device="meta")
    vec = rules.sharding((sh.SLOT,), mesh, dims=(n_slots,))

    def rows(*rest):
        return rules.sharding((sh.SLOT,) + (None,) * len(rest), mesh,
                              dims=(n_slots,) + rest)

    draft = {}
    if draft_cfg is not None:
        draft = engine.cache_shardings(
            draft_cfg, rules, mesh, row_axis=sh.SLOT,
            cache=engine.make_cache(draft_cfg, n_slots, max_len,
                                    device="meta"))
    return dict(
        cache=engine.cache_shardings(cfg, rules, mesh, cache=cache,
                                     row_axis=sh.SLOT),
        next_token=vec, cur_len=vec, n_emitted=vec, budget=vec,
        active=vec, done=vec, request_id=vec, keys=rows(2),
        out=rows(max_new_cap), prompt=rows(prompt_len), plen=vec,
        pf_pos=vec, prefilling=vec, prefix=rows(prefix_len, cfg.d_model),
        draft=draft, slot_accepted=vec, slot_windows=vec, slot_layers=vec,
        slot_decodes=vec, priority=vec, deadline=vec)


class DecodeScheduler:
    """Continuous-batching host loop over a slot pool.

    Args:
      params / cfg: the port's parameters (``bridge``) and config; the
        pool lives on the parameters' device, ``cfg.attn_impl`` selects
        the attention path and ``cfg.ssm.scan_impl`` the scan.
      n_slots: decode slots (rows of the cache).
      prompt_len: longest prompt accepted (the only length accepted for
        a pure-SSM, hybrid or MoE model).
      max_new_cap: largest per-request ``max_new``.
      prefix_len: a VLM pool's patch prefix, ``cfg.n_patches`` (every
        request then brings ``prefix_embeds``), else 0.
      admit_threshold: one-shot coalescing: while some slot is busy,
        wait until this many requests (or the whole queue) can be
        admitted in one prefill.
      kv: "dense" or "paged" KV cache; ``kv_block``/``kv_blocks`` size
        the paged pool (default: dense-equivalent capacity).
      prefill: "oneshot" (default) or "chunked" (attention-decoder
        families: dense, MoE, VLM).
      chunk_tokens: chunked mode: prompt positions each prefilling slot
        advances per iteration.
      loop: the segment's lowering: None (a CUDA graph on a CUDA pool,
        the host-read loop on the CPU), "graph" or "host".
      sampling: ``SamplingParams`` (greedy by default).
      seed: base PRNG seed; request r's key is ``fold_in(PRNGKey(seed),
        r)``, derived on the device at admission, unless ``submit`` is
        given an explicit key.
      speculative: a ``speculative.SpecConfig`` makes every decode
        iteration draft k / verify once (module docstring). Needs
        ``prefill="chunked"``.
      draft_params / draft_cfg: the draft model of
        ``SpecConfig(drafter="model")``: a dense LM with the target's
        vocab, on the target's device; its cache is a dense pool
        register prefilled alongside the target.
      prefix_cache: share full prompt blocks between requests (module
        docstring). Needs ``prefill="chunked"`` and ``kv="paged"``.
      prefill_only: the prefill tier of a disaggregated deployment
        (module docstring). Needs ``prefill="chunked"`` and
        ``kv="paged"``, and refuses speculation.
      rules / mesh: a ``ShardingRules`` and its ``DeviceMesh``: the pool
        is placed over the data axes, and a model axis splits the
        weights and the K/V heads (module docstring); every rank of the
        mesh builds the scheduler and drives it alike. Either None: no
        mesh.
    """

    def __init__(self, params, cfg, *, n_slots: int, prompt_len: int,
                 max_new_cap: int, eos_id: int = 1,
                 sampling: sampling_lib.SamplingParams =
                 sampling_lib.SamplingParams(),
                 admit_threshold: int = 1, kv: str = "dense",
                 kv_block: int = 16, kv_blocks: Optional[int] = None,
                 prefill: str = "oneshot", chunk_tokens: int = 16,
                 loop: Optional[str] = None, seed: int = 0,
                 speculative: Optional[spec_lib.SpecConfig] = None,
                 draft_params=None, draft_cfg=None,
                 prefix_cache: bool = False, prefill_only: bool = False,
                 prefix_len: int = 0, rules=None, mesh=None):
        if n_slots < 1 or max_new_cap < 1:
            raise ValueError("need n_slots >= 1 and max_new_cap >= 1")
        if not 1 <= admit_threshold <= n_slots:
            raise ValueError("admit_threshold must be in [1, n_slots]")
        if kv not in ("dense", "paged"):
            raise ValueError(f"kv must be 'dense' or 'paged'; got {kv!r}")
        if prefill not in ("oneshot", "chunked"):
            raise ValueError(f"prefill must be 'oneshot' or 'chunked'; "
                             f"got {prefill!r}")
        if prefill == "chunked":
            if cfg.family not in engine.ATTN_FAMILIES:
                raise ValueError(
                    f"prefill='chunked' requires an attention-decoder "
                    f"family (dense/moe/vlm); family {cfg.family!r} "
                    f"prefills through a full-prompt forward")
            if chunk_tokens < 1:
                raise ValueError("chunk_tokens must be >= 1")
        if prefix_cache and (prefill != "chunked" or kv != "paged"):
            raise ValueError(
                "prefix_cache=True requires prefill='chunked' (a hit "
                "starts prefilling at its first uncached block, which "
                "only the chunked path's per-row offsets support) and "
                "kv='paged' (sharing is a block-table mapping); got "
                f"prefill={prefill!r}, kv={kv!r}")
        if prefill_only:
            if prefill != "chunked" or kv != "paged":
                raise ValueError(
                    "prefill_only=True (disaggregated prefill tier) "
                    "requires prefill='chunked' and kv='paged': the "
                    "tier exists to run chunked admission and ship "
                    f"block-granular KV; got prefill={prefill!r}, "
                    f"kv={kv!r}")
            if speculative is not None:
                raise ValueError(
                    "a prefill-only tier never decodes; speculative "
                    "decoding belongs on the decode tier")
        if loop not in (None, "graph", "host"):
            raise ValueError(f"loop must be None, 'graph' or 'host'; got "
                             f"{loop!r}")
        if prefix_len and (cfg.family != "vlm"
                           or prefix_len != cfg.n_patches):
            # the prefill derives the patch prefix from cfg.n_patches
            raise ValueError(
                f"prefix_len must be 0, or cfg.n_patches "
                f"({cfg.n_patches}) on a vlm config; got {prefix_len} for "
                f"family {cfg.family!r}")
        if speculative is not None:
            spec_lib.validate(speculative, cfg, prefill, draft_cfg,
                              draft_params, prefix_len)
        elif draft_params is not None or draft_cfg is not None:
            raise ValueError("draft_params/draft_cfg need "
                             "speculative=SpecConfig(drafter='model')")
        self.rules, self.mesh = rules, mesh
        self._meshed = (rules is not None and mesh is not None
                        and mesh.size() > 1)
        if self._meshed:
            if loop == "graph":
                raise ValueError(
                    "a pool on a mesh of more than one device runs the "
                    "host-read segment (each iteration's flags are "
                    "gathered from every shard, which a captured graph "
                    "cannot do): pass loop=None or 'host'")
            loop = "host"
        # the model axis: each rank's slices of the weights (module
        # docstring); on a mesh without one, every leaf as a plain tensor
        self._model = (sh.mesh_shape(mesh).get("model", 1)
                       if self._meshed else 1)
        self._split = self._draft_split = sh.WHOLE
        if self._meshed:
            params, self._split = sh.serve_slices(
                params, model_zoo.param_axes(cfg), rules, mesh,
                model_zoo.serve_parts(cfg))
            if draft_params is not None:
                draft_params, self._draft_split = sh.serve_slices(
                    draft_params, model_zoo.param_axes(draft_cfg),
                    model_zoo.make_rules(draft_cfg, mesh), mesh,
                    model_zoo.serve_parts(draft_cfg))
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        if loop is None:
            loop = "graph" if self.device.type == "cuda" else "host"
        self._graph = loop == "graph"
        self.n_slots, self.prompt_len = n_slots, prompt_len
        self.max_new_cap = max_new_cap
        self.eos_id = int(eos_id)
        self.sampling = sampling
        self.speculative = speculative
        self.draft_cfg, self._draft_params = draft_cfg, draft_params
        self._base_key = prng.prng_key(seed, self.device)
        self.admit_threshold = admit_threshold
        self.prefix_len = int(prefix_len)
        self.max_len = prompt_len + self.prefix_len + max_new_cap + 1
        self.prefill = prefill
        self._chunked = prefill == "chunked"
        self.prefill_only = bool(prefill_only)
        self.chunk_tokens = int(chunk_tokens)
        self.kv, self.kv_block = kv, kv_block
        self.kv_blocks = (n_slots * kvc.blocks_needed(self.max_len, kv_block)
                          if kv_blocks is None else int(kv_blocks))
        # the pool's split over the data axes: ``_shards`` ranks' worth
        # (1: whole on every rank), this rank's shard, and its slots and
        # blocks
        self._axes = sh.data_axes(rules) if self._meshed else ()
        D = rules.axis_size(sh.SLOT) if self._meshed else 1
        split = (D > 1 and n_slots % D == 0 and self.kv_blocks % D == 0
                 and cfg.family != "moe")
        self._shards = D if split else 1
        self._shard = sh.data_index(mesh, self._axes) if split else 0
        self._n_loc = n_slots // self._shards
        self._kv_loc = self.kv_blocks // self._shards
        self._kv_key = engine.kv_key(cfg)
        # Right padding is exact only for pure-attention prefills
        # (causal masking keeps real tokens blind to pad lanes); an SSM
        # recurrence folds the pad tail into its state, and MoE routing
        # lets pad tokens displace real ones from expert slots (in a
        # ragged final chunk too), so those prompts must have exactly
        # prompt_len tokens. The audio family admits one-shot only.
        self._bucketed = cfg.family in (("dense", "vlm") if self._chunked
                                        else ("dense", "vlm", "audio"))
        self._next_rid = 0
        self.queue: List[_Queued] = []
        # host mirrors of slot occupancy and (paged) free blocks, kept
        # in step with the device so admission never reads the device
        self._busy = np.zeros(n_slots, bool)
        self._slot_blocks = np.zeros(n_slots, np.int64)
        # free blocks of each shard (one entry off a mesh)
        self._free_blocks = np.full(self._shards, self._kv_loc, np.int64)
        # each resident slot's request (preemption re-queues from it; the
        # SLO layer reads its priority)
        self._slot_req: List[Optional[_Queued]] = [None] * n_slots
        # host mirrors of device state as of the last harvest, kept
        # exact between segments by admission and preemption
        self._h_out = np.zeros((n_slots, max_new_cap), np.int32)
        self._h_n_emitted = np.zeros(n_slots, np.int64)
        self._h_prefilling = np.zeros(n_slots, bool)
        self._h_reclaim = np.zeros(n_slots, np.int64)
        self._reclaim_fresh = True
        # prefix cache: the index, and per slot the keys it hit and the
        # (key, column) pairs it registered
        self.prefix_cache = bool(prefix_cache)
        self._prefix_index = (_PrefixIndex(kv_block) if prefix_cache
                              else None)
        self._slot_hits: List[List[bytes]] = [[] for _ in range(n_slots)]
        self._slot_regs: List[List[tuple]] = [[] for _ in range(n_slots)]
        self._unfilled = False     # registrations whose block id is unread
        self.prefix_hit_blocks = 0     # blocks mapped instead of prefilled
        self.prefix_evictions = 0
        self.cross_rank_block_copies = 0   # hit blocks copied across shards
        self.peak_resident = 0         # most co-resident requests, taken
        #                                right after each admission
        self.preemptions = 0
        self.tokens_emitted = 0
        # run counters: host reads (flag reads and harvests), segments,
        # graph launches; the device counters as last harvested
        self.host_reads = self.segments = self.graph_replays = 0
        self._counts = np.zeros(4, np.int64)
        self._launches = np.zeros(len(_COUNTED), np.int64)
        # slot_accepted and slot_windows as last harvested
        self._spec_counts = np.zeros((2, n_slots), np.int64)
        # adaptive depth: the harvested requests' totals, and
        # slot_layers / slot_decodes as last harvested
        self.depth_layers = self.depth_tokens = 0
        self._h_depth = np.zeros((2, n_slots), np.int64)
        self._per_branch: Dict[str, List[int]] = {}  # counts at capture
        self._loop: Optional[device_loop.DeviceLoop] = None
        self.capture_seconds = 0.0     # wall time of the segment's capture
        self.pool = self._init_pool()
        # the pool as DTensors on the mesh (the same storage), or the pool
        self.sharded_pool = self._place_pool()
        # the table as each admission left it (prefix cache only): the
        # harvest reads registered block ids from it, since a slot that
        # retires within its first segment has its table row cleared
        self._reg_table = (torch.full_like(self.pool.cache[self._kv_key].table,
                                          -1) if prefix_cache else None)
        # the host buffer of each segment's want/max_steps write
        self._limits = torch.zeros(2, dtype=torch.int32)
        # the stream the scheduler works on, whichever thread calls it
        self._stream = None
        # recorded after each launched segment (``segment_done``)
        self._seg_event = None
        if self.device.type == "cuda":
            self._limits = self._limits.pin_memory()
            self._stream = torch.cuda.current_stream(self.device)
            self._seg_event = torch.cuda.Event()

    # ---------------- pool construction ----------------

    def _init_pool(self) -> SlotPool:
        """This rank's pool: its shard of the slots and blocks."""
        n, dev = self._n_loc, self.device

        def z(*shape, dtype=torch.int32, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        draft_heads = (engine.local_kv_heads(self._draft_params,
                                             self.draft_cfg)
                       if self.draft_cfg is not None else None)
        return SlotPool(
            cache=engine.make_cache(self.cfg, n, self.max_len,
                                    kv_impl=self.kv, kv_block=self.kv_block,
                                    kv_blocks=self._kv_loc,
                                    kv_sharing=self.prefix_cache,
                                    kv_heads=engine.local_kv_heads(
                                        self.params, self.cfg),
                                    inner=engine.local_inner(self.params,
                                                             self.cfg),
                                    device=dev),
            next_token=z(n), cur_len=z(n, fill=1), n_emitted=z(n),
            budget=z(n), active=z(n, dtype=torch.bool),
            done=z(n, dtype=torch.bool), request_id=z(n, fill=-1),
            keys=z(n, 2, dtype=torch.int64), out=z(n, self.max_new_cap),
            prompt=z(n, self.prompt_len if self._chunked else 0),
            plen=z(n), pf_pos=z(n), prefilling=z(n, dtype=torch.bool),
            prefix=z(n, self.prefix_len if self._chunked else 0,
                     self.cfg.d_model, dtype=self.cfg.dtype("compute")),
            draft=(engine.make_cache(self.draft_cfg, n, self.max_len,
                                     kv_heads=draft_heads, device=dev)
                   if self.draft_cfg is not None else {}),
            steps=z(), slot_steps=z(), chunk_steps=z(), decode_steps=z(),
            launches=z(len(_COUNTED), dtype=torch.int64),
            slot_accepted=z(n), slot_windows=z(n), slot_layers=z(n),
            slot_decodes=z(n), priority=z(n),
            deadline=z(n, dtype=torch.float32, fill=float("inf")),
            limits=z(2), seg_start=z())

    def _place_pool(self) -> SlotPool:
        """``pool`` with every slot-state tensor as a DTensor over the
        mesh, viewing the same storage: ``pool_shardings``' placements on
        the data axes and, where the weights split over it, on the model
        axis (the caches' K/V heads under ``CACHE_KV``), replicated over
        the other axes and wherever the pool is replicated (module
        docstring). The counters stay this rank's plain tensors. Off a
        mesh (or on one device): ``pool``."""
        if not self._meshed:
            return self.pool
        from torch.distributed.tensor import DTensor, Replicate
        mesh, names = self.mesh, list(self.mesh.mesh_dim_names)
        chunked = self._chunked
        want = pool_shardings(
            self.cfg, self.n_slots, self.max_len, self.max_new_cap,
            self.rules, mesh, kv=self.kv, kv_block=self.kv_block,
            kv_blocks=self.kv_blocks,
            prompt_len=self.prompt_len if chunked else 0,
            prefix_len=self.prefix_len if chunked else 0,
            draft_cfg=self.draft_cfg)

        def keep(i):
            return ((self._shards > 1 and names[i] in self._axes)
                    or (self._model > 1 and names[i] == "model"))

        def view(local, placements):
            pl = [p if keep(i) else Replicate()
                  for i, p in enumerate(placements)]
            shape = list(local.shape)
            for i, p in enumerate(pl):
                if p.is_shard():
                    shape[p.dim] *= mesh.size(i)
            shape = torch.Size(shape)
            return DTensor.from_local(
                local, mesh, pl, run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())

        def tree(local, placements):
            if isinstance(local, dict):
                return {k: tree(v, placements[k]) for k, v in local.items()}
            if hasattr(local, "shardings"):    # a KVCache node
                return {k: view(getattr(local, k), placements[k])
                        for k in placements}
            return view(local, placements)

        out = {}
        for f in dataclasses.fields(SlotPool):
            local = getattr(self.pool, f.name)
            out[f.name] = (local if f.name in _COUNTER_FIELDS
                           else tree(local, want[f.name]))
        return SlotPool(**out)

    # ---------------- device-side steps -------------------------------

    # Both admissions take ``slots``, a permutation of the slot ids
    # whose ``mask``ed entries are the free slots being filled; the other
    # entries rewrite their own values.

    def _reserve(self, slots, budget, mask, shared=None, pin=None,
                 evict=None) -> None:
        """Release the index pins of ``evict``, release whatever the
        freed slots last held, then reserve each admitted request's
        budget of positions, mapping ``shared`` blocks and pinning
        ``pin`` columns (nothing to do without a K/V cache)."""
        if self._kv_key is not None:
            node = self.pool.cache[self._kv_key]
            if evict is not None:
                node.release(evict)
            node.free(slots, mask=mask)
            node.alloc(slots, budget, mask=mask, shared=shared, pin=pin)

    def _register(self, slots, mask, **regs) -> None:
        """Write each ``SlotPool`` register named in ``regs`` at the
        admitted slots."""
        idx = slots.long()
        for name, new in regs.items():
            vec = getattr(self.pool, name)
            m = mask.reshape((-1,) + (1,) * (vec.dim() - 1))
            vec[idx] = torch.where(m, new.to(vec.dtype), vec[idx])

    def _request_keys(self, rids, keys, derive):
        """Each admitted request's key: ``fold_in(PRNGKey(seed), rid)``
        where ``derive``, else the key given at submission."""
        return torch.where(derive[:, None],
                           prng.fold_in(self._base_key, rids), keys)

    def _keys_at(self, keys, emitted):
        """The keys of the tokens at emission indices ``emitted`` (None
        under greedy, which draws nothing)."""
        if self.sampling.greedy:
            return None
        return sampling_lib.step_keys(keys, emitted)

    def _admit(self, prompts, true_lens, slots, rids, max_news, keys,
               derive, mask, prios, deadlines, prefix=None,
               frames=None) -> None:
        """One-shot admission: up to n requests in ONE prefill. prompts
        (n, Sb) right-padded to the bucket width Sb; true_lens (n,) real
        prompt lengths; ``prefix`` (n, prefix_len, d) a VLM pool's patch
        embeds; ``frames`` (n, n_frames, d) an audio pool's frames.
        Unmasked rows keep their slot: no K/V write (masked in the
        prefill) and their own state (SSM state, cross K/V) spliced
        back."""
        p, n = self.pool, self._n_loc
        pl = self.prefix_len
        self._reserve(slots, true_lens + pl + max_news + 1, mask)
        logits, fresh = engine.prefill(self.params, self.cfg, prompts,
                                       p.cache, rows=slots, mask=mask,
                                       prefix_embeds=prefix, frames=frames,
                                       split=self._split)
        # the first token comes from each row's LAST REAL position
        # (bucketed rows are right-padded), at emission index 0
        rows = torch.arange(n, device=self.device)
        rkeys = self._request_keys(rids, keys, derive)
        tok0 = sampling_lib.sample_slots(
            logits[rows, (true_lens + pl - 1).long()],
            self._keys_at(rkeys, torch.zeros_like(rids)), self.sampling)
        idx = slots.long()
        for key, state in fresh.items():
            for leaf, new in state.items():
                # spliced leaves carry the slot dim at axis 1
                full = p.cache[key][leaf]
                m = mask.reshape((1, n) + (1,) * (full.dim() - 2))
                full[:, idx] = torch.where(m, new.to(full.dtype),
                                           full[:, idx])
        zeros = torch.zeros_like(rids)
        self._register(slots, mask, next_token=tok0,
                       cur_len=true_lens + pl + 1,
                       n_emitted=zeros, budget=max_news,
                       active=torch.ones_like(mask), done=zeros.bool(),
                       request_id=rids, keys=rkeys,
                       out=torch.zeros_like(p.out), priority=prios,
                       deadline=deadlines, slot_layers=zeros,
                       slot_decodes=zeros)

    def _assign(self, prompts, plens, slots, rids, max_news, keys, derive,
                mask, prios, deadlines, prefix=None, shared=None, pin=None,
                pf0=None, evict=None, draft_from=0) -> None:
        """Chunked admission: release ``evict``'s index pins, reserve the
        slots' blocks (mapping ``shared`` hit blocks, pinning ``pin``
        columns) and register the requests as PREFILLING from ``pf0``
        (a hit starts at its first uncached block); plens (n,) are
        stream lengths (a VLM's patch prefix, then the prompt), and
        ``prefix`` its patch embeds. No model forward, except for a
        model drafter after a prefix hit: its own dense cache shares
        nothing, so the draft model prefills positions ``[0,
        draft_from)`` of the admitted rows here (``draft_from`` is the
        longest hit run in positions, 0 without a hit), and the chunks
        then advance target and draft together from each row's hit."""
        self._reserve(slots, plens + max_news + 1, mask, shared, pin, evict)
        zeros = torch.zeros_like(rids)
        regs = {}
        if prefix is not None:
            regs["prefix"] = prefix
        self._register(slots, mask, next_token=zeros, cur_len=zeros + 1,
                       n_emitted=zeros, budget=max_news,
                       active=zeros.bool(), done=zeros.bool(),
                       request_id=rids,
                       keys=self._request_keys(rids, keys, derive),
                       out=torch.zeros_like(self.pool.out),
                       prompt=prompts, plen=plens,
                       pf_pos=zeros if pf0 is None else pf0,
                       prefilling=torch.ones_like(mask), priority=prios,
                       deadline=deadlines, slot_layers=zeros,
                       slot_decodes=zeros, **regs)
        if self.pool.draft and draft_from:
            admitted = torch.zeros_like(self.pool.active)
            admitted[slots.long()] = mask & (pf0 > 0)
            engine.prefill_chunk(self._draft_params, self.draft_cfg,
                                 self.pool.prompt, self.pool.draft,
                                 torch.zeros_like(self.pool.pf_pos),
                                 chunk=int(draft_from), mask=admitted,
                                 split=self._draft_split)
        if self._reg_table is not None:
            admitted = torch.zeros_like(self.pool.active)
            admitted[slots.long()] = mask
            self._reg_table.copy_(torch.where(
                admitted[:, None], self.pool.cache[self._kv_key].table,
                self._reg_table))

    def _preempt(self, mask, evict) -> None:
        """Free the masked slots' rows (blocks shared with other rows or
        pinned by the index survive), after releasing ``evict``'s pins,
        and return their registers to FREE, in place."""
        p = self.pool
        if self._kv_key is not None:
            node = p.cache[self._kv_key]
            if evict is not None:
                node.release(evict)
            node.free(mask=mask)
        keep = ~mask
        for reg in (p.active, p.prefilling, p.done):
            reg.logical_and_(keep)
        for reg, fill in ((p.request_id, -1), (p.budget, 0),
                          (p.n_emitted, 0), (p.cur_len, 1), (p.pf_pos, 0),
                          (p.plen, 0), (p.slot_layers, 0),
                          (p.slot_decodes, 0)):
            reg.masked_fill_(mask, fill)

    def _chunk(self) -> None:
        """Advance every PREFILLING slot by one chunk; a slot whose
        chunk covers its last prompt position samples its first token
        there and turns RUNNING. Registers are written in place (a
        captured graph keeps their addresses)."""
        p, C, n = self.pool, self.chunk_tokens, self._n_loc
        logits = engine.prefill_chunk(
            self.params, self.cfg, p.prompt, p.cache, p.pf_pos, chunk=C,
            mask=p.prefilling,
            prefix_embeds=p.prefix if self.prefix_len else None,
            split=self._split)
        if p.draft:
            # the draft model prefills the same chunk into its own cache;
            # its logits are not used (the first token is the target's)
            engine.prefill_chunk(self._draft_params, self.draft_cfg,
                                 p.prompt, p.draft, p.pf_pos, chunk=C,
                                 mask=p.prefilling, split=self._draft_split)
        fin = self._finishing(p)
        last = (p.plen - 1 - p.pf_pos).clamp(0, C - 1).long()
        rows = torch.arange(n, device=self.device)
        t0 = sampling_lib.sample_slots(
            logits[rows, last], self._keys_at(p.keys, torch.zeros_like(
                p.n_emitted)), self.sampling)
        p.next_token.copy_(torch.where(fin, t0, p.next_token))
        p.cur_len.copy_(torch.where(fin, p.plen + 1, p.cur_len))
        p.pf_pos.copy_(torch.where(p.prefilling, p.pf_pos + C, p.pf_pos))
        p.prefilling.copy_(p.prefilling & ~fin)
        if self.prefill_only:
            # the prefill tier: the row waits, DONE, for its shipment
            p.done.copy_(p.done | fin)
        else:
            p.active.copy_(p.active | fin)

    def _finishing(self, p: SlotPool) -> torch.Tensor:
        """The prefilling slots whose next chunk covers their last prompt
        position."""
        return p.prefilling & (p.pf_pos + self.chunk_tokens >= p.plen)

    def _live(self, emit, cfg, warm: bool):
        """The rows that keep an early-exit layer loop alive: the
        emitting ones (None without early exit, and in the warm-up
        before capture, where every row runs every layer so that each
        op's lazy initialisation happens outside the capture)."""
        return emit if cfg.early_exit and not warm else None

    def _decode(self, warm: bool = False) -> None:
        """Emit each RUNNING slot's pending token, retire slots that hit
        EOS or their budget (freeing their blocks on the device), and
        decode every slot one token. In chunked mode appends are gated
        to emitting rows: a mid-prefill slot's stale ``cur_len`` points
        into its prompt. In one-shot mode idle rows may write garbage:
        admission rewrites a row's cache before it is read again. With
        early exit only the rows that go on (emitting and not retiring)
        keep the layer loop alive, and the depth of each decode whose
        token will be emitted goes to the slot's counters: a retiring
        row's last decode reads blocks it has just freed, so its depth
        would depend on the other rows of the pool. Registers are
        written in place."""
        p, n = self.pool, self._n_loc
        tok, emit = p.next_token, p.active
        rows = torch.arange(n, device=self.device)
        idx = p.n_emitted.clamp(0, self.max_new_cap - 1).long()
        p.out[rows, idx] = torch.where(emit, tok, p.out[rows, idx])
        p.n_emitted.add_(emit.int())
        finished = emit & ((tok == self.eos_id) | (p.n_emitted >= p.budget))
        active = emit & ~finished      # a new tensor: ``emit`` is a register
        if self._kv_key is not None:
            p.cache[self._kv_key].free(mask=finished)
        logits, depth = engine.decode_step(
            self.params, self.cfg, tok[:, None], p.cache, p.cur_len,
            write_mask=emit if self._chunked else None,
            live=self._live(active, self.cfg, warm), with_depth=True,
            split=self._split)
        nxt = sampling_lib.sample_slots(
            logits[:, 0], self._keys_at(p.keys, p.n_emitted), self.sampling)
        kept = active.int()
        p.slot_layers.add_(kept * depth)
        p.slot_decodes.add_(kept)
        p.next_token.copy_(torch.where(active, nxt, tok))
        p.cur_len.add_(active.int())
        p.active.copy_(active)
        p.done.copy_(p.done | finished)

    def _spec_decode(self, warm: bool = False) -> None:
        """One draft-k / verify-once iteration for every RUNNING slot (the
        JAX package's ``spec_decode_fn``): draft, score the window
        ``[pending, d_1..d_k]`` in one ``verify_step`` at ``cur_len - 1``,
        accept a prefix, and emit ``m = min(accepted + 1, room, up to the
        first EOS)`` tokens; ``cur_len`` advances by m. Rejected drafts
        are not rolled back: their lanes lie at or past the new
        ``cur_len - 1``, where the next window writes before it reads. A
        slot that finishes retires and frees its blocks here. A draft
        model with early exit drafts at adaptive depth; the verify runs
        the target at full depth, so each emitted token counts
        ``n_layers`` blocks. Registers are written in place."""
        p, n, k = self.pool, self._n_loc, self.speculative.k
        cap, eos = self.max_new_cap, self.eos_id
        emit, t0 = p.active, p.next_token
        dev = self.device
        if not p.draft:
            drafts = spec_lib.draft_ngram(p.prompt, p.plen - self.prefix_len,
                                          p.out, p.n_emitted, t0, k=k,
                                          ngram=self.speculative.ngram)
        else:
            # k+1 greedy draft steps: the draft cache's valid prefix then
            # ends at the window's end, and the next window rewrites
            # whatever lies past the accepted point
            toks, tok = [], t0
            for j in range(k + 1):
                dl = engine.decode_step(
                    self._draft_params, self.draft_cfg, tok[:, None],
                    p.draft, p.cur_len + j, write_mask=emit,
                    live=self._live(emit, self.draft_cfg, warm),
                    split=self._draft_split)
                tok = torch.argmax(dl[:, 0], dim=-1).to(torch.int32)
                if j < k:
                    toks.append(tok)
            drafts = torch.stack(toks, dim=1)
        window = torch.cat([t0[:, None], drafts], dim=1)           # (n, k+1)
        logits = engine.verify_step(self.params, self.cfg, window, p.cache,
                                    p.cur_len, write_mask=emit,
                                    split=self._split)
        # keys of emission indices n_emitted + 1 .. n_emitted + k + 1
        wkeys = (None if self.sampling.greedy else
                 sampling_lib.window_keys(p.keys, p.n_emitted + 1, k + 1))
        acc, nxt = spec_lib.accept(logits, drafts, wkeys, self.sampling)
        jw = torch.arange(k + 1, device=dev)
        room = (p.budget - p.n_emitted).long()
        eos_pos = torch.where((window == eos) & (jw[None] <= acc[:, None]),
                              jw[None], k + 1).amin(dim=1)
        m = torch.minimum(acc + 1, torch.minimum(room, eos_pos + 1))
        m = torch.where(emit, m, 0)
        # emissions land at out[:, n_emitted : n_emitted + m]
        rel = torch.arange(cap, device=dev)[None] - p.n_emitted.long()[:, None]
        put = (rel >= 0) & (rel < m[:, None])
        landed = torch.gather(window, 1, rel.clamp(0, k))
        rows = torch.arange(n, device=dev)
        last_tok = window[rows, (m - 1).clamp(min=0)]
        n_emitted = p.n_emitted + m.int()
        finished = emit & ((last_tok == eos) | (n_emitted >= p.budget))
        active = emit & ~finished      # a new tensor: ``emit`` is a register
        if self._kv_key is not None:
            p.cache[self._kv_key].free(mask=finished)
        p.out.copy_(torch.where(put, landed, p.out))
        p.slot_accepted.add_(torch.where(emit, m - 1, 0).int())
        p.slot_windows.add_(emit.int())
        p.slot_layers.add_(m.int() * self.cfg.n_layers)
        p.slot_decodes.add_(m.int())
        p.n_emitted.copy_(n_emitted)
        p.next_token.copy_(torch.where(active, nxt, t0))
        p.cur_len.add_(m.int())
        p.active.copy_(active)
        p.done.copy_(p.done | finished)

    def _chunk_branch(self) -> None:
        self._chunk()
        self.pool.chunk_steps.add_(1)

    def _decode_body(self, warm: bool = False) -> None:
        """The decode branch's work: a speculative window or one token."""
        if self.speculative is not None:
            self._spec_decode(warm)
        else:
            self._decode(warm)

    def _decode_branch(self) -> None:
        p = self.pool
        p.slot_steps.add_(p.active.sum().int())
        p.decode_steps.add_(1)
        self._decode_body()

    # ---------------- the segment (the JAX package's ``step``) ---------

    def _seg_enter(self, p: SlotPool) -> None:
        """Entering a segment means the host harvested the last one:
        clear ``done``, and note the iteration count at entry."""
        p.done.zero_()
        p.seg_start.copy_(p.steps)

    def _seg_cond(self, p: SlotPool) -> torch.Tensor:
        """The JAX package's ``cond_fn``: some slot busy, fewer than
        ``want`` idle, fewer than ``max_steps`` iterations this segment."""
        busy = p.active | p.prefilling
        idle = self._n_loc - busy.sum()
        return busy.any() & (idle < p.limits[0]) & \
            (p.steps - p.seg_start < p.limits[1])

    def _seg_body(self, p: SlotPool) -> SlotPool:
        if self._chunked:
            core.cond(p.prefilling.any(), self._captured_branch(
                self._chunk_branch, "chunk"), _noop, backend="graph")
            if not self.prefill_only:
                core.cond(p.active.any(), self._captured_branch(
                    self._decode_branch, "decode"), _noop, backend="graph")
        else:
            self._captured_branch(self._decode_branch, "decode")()
        p.steps.add_(1)
        return p

    def _captured_branch(self, fn, key: str):
        """``fn`` for capture: the kernel wrappers' counters move while
        Python captures it, not when the device runs it, so the counts are
        kept per branch (what one run of the branch launches) and the
        counters put back."""
        def run():
            before = [getattr(o, a) for o, a in _LAUNCH_COUNTERS]
            fn()
            self._per_branch[key] = [getattr(o, a) - b for (o, a), b
                                     in zip(_LAUNCH_COUNTERS, before)]
            for (o, a), b in zip(_LAUNCH_COUNTERS, before):
                setattr(o, a, b)
        return run

    def _read_flags(self) -> List[bool]:
        """The host-read loop's one read per iteration: the segment
        predicate (``_seg_cond``) and the two branch decisions, both taken
        before the chunk runs: some slot prefills; some slot decodes (one
        runs, or its chunk this iteration finishes its prompt)."""
        p = self.pool
        decode = (p.active.any() if self.prefill_only else
                  (p.active | self._finishing(p)).any())
        self.host_reads += 1
        if self._shards == 1:
            flags = torch.stack([self._seg_cond(p), p.prefilling.any(),
                                 decode])
            return device_loop.read_host(flags)[0].tolist()
        # a sharded pool: the whole pool's predicate and branches, from
        # every shard's busy count and branch decisions
        local = torch.stack([(p.active | p.prefilling).sum().int(),
                             p.prefilling.any().int(), decode.int(),
                             (p.steps - p.seg_start).int()])
        (vals,) = device_loop.read_host(local)
        got = np.stack(sh.gather_shards(self.mesh, self._axes,
                                        vals.astype(np.int64)))
        busy = int(got[:, 0].sum())
        want, max_steps = (int(v) for v in self._limits.numpy())
        go = busy > 0 and self.n_slots - busy < want \
            and int(vals[3]) < max_steps
        return [go, bool(got[:, 1].any()), bool(got[:, 2].any())]

    def _segment_host(self) -> None:
        """The segment with its decisions on the host."""
        p = self.pool
        self._seg_enter(p)
        while True:
            go, chunk, decode = self._read_flags()
            if not go:
                return
            if chunk:
                self._chunk_branch()
            if decode:
                self._decode_branch()
            p.steps.add_(1)

    def _segment(self, want: int, max_steps: int = _NO_STEP_CAP) -> None:
        """Iterate while some slot is busy, fewer than ``want`` slots are
        idle and fewer than ``max_steps`` iterations have run: write the
        two limits (one H2D copy), then run the segment."""
        self.segments += 1
        self._limits.numpy()[:] = (want, max_steps)
        self.pool.limits.copy_(self._limits, non_blocking=True)
        if not self._graph:
            self._segment_host()
            return
        if self._loop is None:
            self._capture()
        self._loop.run()
        self.graph_replays += 1

    def _capture(self) -> None:
        """Run the body once eagerly on the idle pool (each branch is a
        no-op there: masked writes, unchanged registers; an early-exit
        layer loop runs with every row live), so that lazy
        initialisation (the kernels' build, cuBLAS, cached constants)
        happens before capture; then capture the segment loop, with the
        kernel launches counted on the device."""
        if self._busy.any():
            raise RuntimeError("the segment is captured on an idle pool")
        with torch.no_grad():
            if self._chunked:
                self._chunk()
            if not self.prefill_only:
                self._decode_body(warm=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.no_grad(), kernels.device_launch_counts(
                self.pool.launches, _COUNTED):
            self._loop = device_loop.DeviceLoop(
                self._seg_cond, self._seg_body, self.pool,
                prologue=self._seg_enter, name="serve_step")
        self.capture_seconds = time.perf_counter() - t0

    def warmup(self) -> None:
        """Build the kernels and capture the segment before serving (the
        JAX package's ``warmup`` compiles its traces). Needs an idle
        scheduler; the first segment does it otherwise. A no-op on the
        host-read loop."""
        if self._busy.any() or self.queue:
            raise RuntimeError("warmup() must run on an idle scheduler")
        if self._graph and self._loop is None:
            with self._on_device():
                self._capture()

    def close(self) -> None:
        """Free the captured segment (its graphs and memory pool)."""
        if self._loop is not None:
            self._loop.close()
            self._loop = None

    @property
    def loop_impl(self) -> str:
        """Which lowering runs the segment: "cuda-graph:while" or
        "host-read"."""
        return "cuda-graph:while" if self._graph else "host-read"

    # ---------------- host side ---------------------------------------

    @property
    def free_slots(self) -> int:
        return int(self.n_slots - self._busy.sum())

    @property
    def free_blocks(self) -> int:
        """Host mirror of the paged free-list (pool capacity for dense),
        summed over the shards."""
        return int(self._free_blocks.sum())

    @property
    def active_count(self) -> int:
        return int(self._busy.sum())

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in slots)."""
        return len(self.queue) + int(self._busy.sum())

    def blocks_for(self, true_len: int, max_new: int) -> int:
        """Blocks a request holds while resident (0 for dense); agrees
        with the device-side alloc of ``true_len + prefix_len + max_new +
        1``."""
        if self.kv != "paged":
            return 0
        return int(kvc.blocks_needed(true_len + self.prefix_len + max_new
                                     + 1, self.kv_block))

    def submit(self, prompt, *, max_new: int,
               request_id: Optional[int] = None, key=None,
               priority: int = 0, deadline: float = float("inf"),
               prefix_embeds=None, frames=None) -> int:
        """Queue one request. prompt: (1, L) int, 1 <= L <= prompt_len
        (L == prompt_len for a pure-SSM, hybrid or MoE model).
        ``prefix_embeds`` (1, prefix_len, d_model): a VLM request's patch
        embeddings, required on a pool built with ``prefix_len`` and
        refused otherwise. ``frames`` (1, n_frames, d_model): an audio
        request's frame embeddings, required for the audio family and
        refused for the others. key: the request's PRNG
        key, two uint32 words (a JAX raw key); None derives
        ``fold_in(PRNGKey(seed), request_id)`` at admission.
        ``priority`` (lower = more urgent) and ``deadline`` (host-clock
        seconds) are registered with the slot; this FIFO driver ignores
        them, the SLO layer (``serve.slo``) orders and preempts by
        them."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 2 or prompt.shape[0] != 1 or \
                not 1 <= prompt.shape[1] <= self.prompt_len:
            raise ValueError(f"prompt must be (1, L) with 1 <= L <= "
                             f"{self.prompt_len}; got {prompt.shape}")
        if not self._bucketed and prompt.shape[1] != self.prompt_len:
            raise ValueError(
                f"family {self.cfg.family!r} requires exact-length "
                f"prompts (1, {self.prompt_len}): right-padding is not "
                f"exact for SSM state / MoE routing; got {prompt.shape}")
        if not 1 <= max_new <= self.max_new_cap:
            raise ValueError(f"max_new must be in [1, {self.max_new_cap}]")
        need = self.blocks_for(prompt.shape[1], max_new)
        if need > self._kv_loc:
            raise ValueError(
                f"request needs {need} cache blocks but the paged pool "
                f"only has kv_blocks={self.kv_blocks}"
                + (f" ({self._kv_loc} a shard)" if self._shards > 1
                   else ""))
        # a pool sized with prefix_len needs the prefix on every request:
        # one admission batch shares one prefill
        if self.prefix_len > 0:
            pe = (np.shape(prefix_embeds) if prefix_embeds is not None
                  else None)
            if pe is None or tuple(pe[:2]) != (1, self.prefix_len):
                raise ValueError(
                    f"this pool was built with prefix_len="
                    f"{self.prefix_len}: every request needs "
                    f"prefix_embeds (1, {self.prefix_len}, d); got {pe}")
            prefix_embeds = np.asarray(prefix_embeds)
        elif prefix_embeds is not None:
            raise ValueError("prefix_embeds on a pool built with "
                             "prefix_len=0; pass prefix_len at "
                             "construction")
        if self.cfg.family == "audio":
            if frames is None or np.shape(frames)[:2] != \
                    (1, self.cfg.n_frames):
                raise ValueError(
                    f"audio pool: every request needs frames "
                    f"(1, {self.cfg.n_frames}, ...); got "
                    f"{None if frames is None else np.shape(frames)}")
            frames = np.asarray(frames)
        elif frames is not None:
            raise ValueError(f"frames invalid for family "
                             f"{self.cfg.family!r}")
        if not self.queue and not self._busy.any():
            # first submission of a fresh run on a drained scheduler:
            # counters describe runs, not scheduler lifetimes
            self.reset_stats()
        rid = self._next_rid if request_id is None else int(request_id)
        self._next_rid = max(self._next_rid, rid) + 1
        if key is not None:
            key = np.asarray(key, np.int64).reshape(2) & 0xFFFFFFFF
        self.queue.append(_Queued(rid, prompt.astype(np.int32),
                                  int(max_new), key, int(priority),
                                  float(deadline), prefix_embeds, frames))
        return rid

    def _bucket(self, length: int) -> int:
        """Power-of-two prefill bucket for a prompt length (one-shot)."""
        if not self._bucketed:
            return self.prompt_len
        b = 1
        while b < length:
            b <<= 1
        return min(b, self.prompt_len)

    # ---------------- shards (a pool split over the data axes) ---------

    def _slot_shard(self, slot: int) -> int:
        return int(slot) // self._n_loc

    def _block_shard(self, block_id: int) -> int:
        return int(block_id) // self._kv_loc

    def _free_slot_order(self, taken=()) -> List[int]:
        """The candidate slots of an admission: the lowest free slot of
        each shard, in slot order (off a mesh: the lowest free slot)."""
        out, seen = [], set()
        for s in np.nonzero(~self._busy)[0]:
            s = int(s)
            r = self._slot_shard(s)
            if s in taken or r in seen:
                continue
            seen.add(r)
            out.append(s)
        return out

    def _local_rows(self, slots, k: int):
        """This shard's part of an admission of ``k`` requests into
        ``slots[:k]`` (a permutation of the slot ids): the rows of the
        admission's host arrays that land here (index ``n``: an extra
        default row), then the local slot ids and the mask of a local
        admission, the admitted rows first. Off a mesh: the arrays as
        they are."""
        n = self.n_slots
        if self._shards == 1:
            mask = np.arange(n) < k
            return np.arange(n), np.asarray(slots, np.int32), mask
        lo = self._shard * self._n_loc
        mine = [i for i in range(k) if lo <= slots[i] < lo + self._n_loc]
        used = {int(slots[i]) - lo for i in mine}
        rest = [j for j in range(self._n_loc) if j not in used]
        idx = np.asarray(mine + [n] * len(rest), np.int64)
        local = np.asarray([int(slots[i]) - lo for i in mine] + rest,
                           np.int32)
        mask = np.arange(self._n_loc) < len(mine)
        return idx, local, mask

    def _local_blocks(self, ids, width: int) -> np.ndarray:
        """The ids in ``ids`` (global block ids) on this shard, as local
        ids, padded with -1 to ``width``."""
        lo = self._shard * self._kv_loc
        out = np.full(width, -1, np.int32)
        mine = [int(b) - lo for b in ids
                if b >= 0 and self._block_shard(b) == self._shard]
        out[:len(mine)] = mine
        return out

    def _local_mask(self, slots) -> torch.Tensor:
        """This shard's part of a mask over the global ``slots``, on the
        device."""
        mask = np.zeros(self.n_slots, bool)
        mask[list(slots)] = True
        lo = self._shard * self._n_loc
        return torch.from_numpy(mask[lo:lo + self._n_loc]).to(self.device)

    def _host_view(self, vals, kinds):
        """The host's view of arrays read from this rank's shard: with the
        pool split, every shard's arrays gathered in one collective and
        combined by ``kinds`` ("rows": concatenated in slot order, "table":
        rows of local block ids, concatenated and made global, "sum":
        added, "mine": this rank's, the same on every rank or its own);
        off a split, ``vals``."""
        if self._shards == 1:
            return list(vals)
        got = sh.gather_shards(self.mesh, self._axes, list(vals))
        out = []
        for j, kind in enumerate(kinds):
            parts = [g[j] for g in got]
            if kind == "rows":
                out.append(np.concatenate(parts))
            elif kind == "table":
                out.append(np.concatenate([
                    np.where(t >= 0, t + r * self._kv_loc, t)
                    for r, t in enumerate(parts)]))
            elif kind == "sum":
                out.append(sum(parts))
            else:
                out.append(vals[j])
        return out

    def _copy_hits(self, copies) -> None:
        """Copy hit blocks into the admitting shard: ``copies`` lists
        (source global block id, slot, table column), the same on every
        rank. Each source shard's blocks travel in one gather of the
        mesh; the destination writes them into the blocks its ``alloc``
        gave the columns (on the device, no read)."""
        if not copies:
            return
        node = self.pool.cache[self._kv_key]
        lo_b = self._shard * self._kv_loc
        mine = [(b - lo_b) for b, _, _ in copies
                if self._block_shard(b) == self._shard]
        payload = None
        if mine:
            ids = torch.tensor(mine, dtype=torch.long, device=self.device)
            payload = (node.k_pool[:, ids].cpu(), node.v_pool[:, ids].cpu())
        got = sh.gather_shards(self.mesh, self._axes, payload)
        taken = [0] * self._shards
        lo_s = self._shard * self._n_loc
        for b, slot, col in copies:
            src = self._block_shard(b)
            j = taken[src]
            taken[src] += 1
            if self._slot_shard(slot) != self._shard:
                continue
            k, v = got[src]
            dst = node.table[slot - lo_s, col].long()
            node.k_pool[:, dst] = k[:, j].to(self.device)
            node.v_pool[:, dst] = v[:, j].to(self.device)

    def _plan_hits(self, q: _Queued, need: int, blocks_free: int,
                   victims: List[bytes], reserved: set, shard: int = 0):
        """Prefix-cache planning for the request at the queue's head, in
        ``shard``: the READY run it hits (capped at ``(plen - 1) //
        block``: one position at least prefills in-row, and every written
        block is fresh, so the scheduler's path never copies on write),
        how much of it the row maps (the leading blocks that live in
        ``shard``; the rest is copied in at admission), and the LRU
        entries of ``shard`` to evict until its fresh blocks fit
        (``victims`` and ``reserved`` grow). Pure on the index. Returns
        (plan, fresh blocks needed, blocks free)."""
        idx = self._prefix_index
        plen = self.prefix_len + q.prompt.shape[1]
        hs = idx.hashes(q.prompt[0], self.prefix_len,
                        idx.seed(q.prefix_embeds))
        hit_keys, hit_ids = idx.lookup(hs, (plen - 1) // self.kv_block,
                                       set(victims))
        mapped = 0
        while mapped < len(hit_ids) and \
                self._block_shard(hit_ids[mapped]) == shard:
            mapped += 1
        need -= mapped
        while need > blocks_free:
            v = idx.pick_victim(reserved | set(hit_keys),
                                lambda b: self._block_shard(b) == shard)
            if v is None:
                break
            victims.append(v)
            reserved.add(v)
            blocks_free += 1          # each victim frees its pinned block
        return {"hs": hs, "hit_keys": hit_keys, "hit_ids": hit_ids,
                "mapped": mapped}, need, blocks_free

    def _commit_hits(self, plans, slots, victims, shared, pin, pf0):
        """Prefix-cache commit: the plan is final. Evict the victims,
        take references on the hit entries each row maps (``shared``, in
        its shard's local ids) and touch the ones it copies, set ``pf0``,
        and register every full block past each hit run PENDING
        (``pin``). Returns each request's (key, column) registrations,
        the evicted block ids and the copies to make (``_copy_hits``)."""
        idx = self._prefix_index
        evicted = [idx.evict(h) for h in victims]
        for b in evicted:
            self._free_blocks[self._block_shard(b)] += 1
        self.prefix_evictions += len(victims)
        regs: List[List[tuple]] = []
        copies: List[tuple] = []
        for i, plan in enumerate(plans):
            slot, mapped = int(slots[i]), plan["mapped"]
            lo = self._slot_shard(slot) * self._kv_loc
            for j, h in enumerate(plan["hit_keys"]):
                if j < mapped:
                    idx.entries[h].row_refs += 1
                idx.touch(h)
            hits = len(plan["hit_ids"])
            shared[i, :mapped] = [b - lo for b in plan["hit_ids"][:mapped]]
            for c in range(mapped, hits):
                b = plan["hit_ids"][c]
                copies.append((b, slot, c))
                if self._block_shard(b) != self._slot_shard(slot):
                    self.cross_rank_block_copies += 1
            pf0[i] = hits * self.kv_block
            self.prefix_hit_blocks += hits
            mine = []
            for c in range(hits, len(plan["hs"])):
                h = plan["hs"][c]
                if h in idx.entries:
                    continue       # an in-flight twin registered it
                idx.register(h)
                pin[i, c] = True
                mine.append((h, c))
            regs.append(mine)
        return regs, evicted, copies

    def _admit_queued(self) -> int:
        """Fill free slots from the queue, FIFO, while each request's
        fresh blocks fit the free-list (head-of-line blocking keeps
        order); a request takes the lowest free slot whose shard fits
        it. With the prefix cache, a planning pass that mutates nothing
        (hits, evictions) comes first, so that coalescing or blocking can
        abandon it, and the commit pass after. ``admit_threshold > 1``
        coalesces: while some slot is busy, a batch smaller than the
        threshold (and than what the queue holds) waits for a later
        round."""
        if not self.queue or self.free_slots == 0:
            return 0
        batch: List[_Queued] = []
        plans: List[Optional[dict]] = []
        chosen: List[int] = []
        victims: List[bytes] = []        # keys planned for eviction
        reserved: set = set()            # keys this round must not evict
        blocks_free = self._free_blocks.copy()
        while self.queue and len(batch) < self.free_slots:
            q = self.queue[0]
            need = self.blocks_for(q.prompt.shape[1], q.max_new)
            pick = first = None
            for slot in self._free_slot_order(chosen):
                r = self._slot_shard(slot)
                plan, vic, res = None, list(victims), set(reserved)
                n_r, free_r = need, int(blocks_free[r])
                if self.prefix_cache:
                    plan, n_r, free_r = self._plan_hits(q, need, free_r,
                                                        vic, res, r)
                first = first or (vic, res)
                if n_r <= free_r:
                    pick = (slot, r, plan, vic, res, n_r, free_r)
                    break
            if pick is None:
                # the head blocks; what its plan evicted in the first
                # shard tried is evicted all the same, as in the JAX
                # package (its plan evicts before it gives up)
                if first is not None:
                    victims, reserved = first
                break
            slot, r, plan, victims, reserved, n_r, free_r = pick
            blocks_free[r] = free_r - n_r
            if plan is not None:
                reserved.update(plan["hit_keys"])
            plans.append(plan)
            chosen.append(slot)
            batch.append(self.queue.pop(0))
        k = len(batch)
        if k == 0:
            return 0
        if k < min(self.admit_threshold, k + len(self.queue)) \
                and self._busy.any():
            self.queue[:0] = batch     # coalesce: admit on a later round
            return 0
        n = self.n_slots
        L = (self.prompt_len if self._chunked
             else max(self._bucket(q.prompt.shape[1]) for q in batch))
        rest = [int(s) for s in np.nonzero(~self._busy)[0]
                if int(s) not in chosen]
        slots = np.asarray(chosen + rest
                           + [int(s) for s in np.nonzero(self._busy)[0]])
        # one row a slot, and a default row (index n) for local padding
        prompts = np.zeros((n + 1, L), np.int32)
        plens = np.full(n + 1, L, np.int32)
        rids = np.full(n + 1, -1, np.int32)
        max_news = np.zeros(n + 1, np.int32)
        keys = np.zeros((n + 1, 2), np.int64)
        derive = np.zeros(n + 1, bool)
        prios = np.zeros(n + 1, np.int32)
        deadlines = np.full(n + 1, np.inf, np.float32)
        for i, q in enumerate(batch):
            tl = q.prompt.shape[1]
            prompts[i, :tl] = q.prompt[0]
            plens[i] = tl
            rids[i] = q.request_id
            max_news[i] = q.max_new
            prios[i] = q.priority
            deadlines[i] = q.deadline
            if q.key is None:
                derive[i] = True
            else:
                keys[i] = q.key
        rows, local_slots, mask = self._local_rows(slots, k)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if self._chunked:
            plens += np.int32(self.prefix_len)    # stream lengths
        args = [dev(prompts[rows]), dev(plens[rows]), dev(local_slots),
                dev(rids[rows]), dev(max_news[rows]), dev(keys[rows]),
                dev(derive[rows]), dev(mask), dev(prios[rows]),
                dev(deadlines[rows])]
        prefix = None
        if self.prefix_len:
            pe = np.zeros((n + 1, self.prefix_len, self.cfg.d_model),
                          np.float32)
            for i, q in enumerate(batch):
                pe[i] = q.prefix_embeds[0]
            prefix = dev(pe[rows]).to(self.cfg.dtype("compute"))
        frames = None
        if self.cfg.family == "audio":
            # zero frames for the rows that admit no request
            fr = np.zeros((n + 1, self.cfg.n_frames, self.cfg.d_model),
                          np.float32)
            for i, q in enumerate(batch):
                fr[i] = q.frames[0]
            frames = dev(fr[rows])
        regs: List[List[tuple]] = [[] for _ in batch]
        here = bool(mask.any())
        if not self._chunked:
            if here:
                self._admit(*args, prefix, frames)
        elif not self.prefix_cache:
            if here:
                self._assign(*args, prefix)
        else:
            bpr = int(kvc.blocks_needed(self.max_len, self.kv_block))
            shared = np.full((n + 1, bpr), -1, np.int32)
            pin = np.zeros((n + 1, bpr), bool)
            pf0 = np.zeros(n + 1, np.int32)
            regs, evicted, copies = self._commit_hits(plans, chosen,
                                                      victims, shared, pin,
                                                      pf0)
            evict = self._local_blocks(evicted, self._kv_loc)
            if here or (evict >= 0).any():
                self._assign(*args, prefix, dev(shared[rows]),
                             dev(pin[rows]), dev(pf0[rows]), dev(evict),
                             draft_from=int(pf0[rows].max()))
            self._copy_hits(copies)
            self._unfilled = self._unfilled or any(regs)
        for i, q in enumerate(batch):
            slot = chosen[i]
            need = self.blocks_for(q.prompt.shape[1], q.max_new)
            self._busy[slot] = True
            self._slot_req[slot] = q
            self._h_n_emitted[slot] = 0
            self._h_depth[:, slot] = 0
            self._h_prefilling[slot] = self._chunked
            if self.prefix_cache:
                mapped = plans[i]["mapped"]
                need -= mapped                        # fresh blocks only
                self._slot_hits[slot] = list(plans[i]["hit_keys"][:mapped])
                self._slot_regs[slot] = regs[i]
                # registered blocks stay pinned by the index after this
                # slot retires; only the rest return at harvest
                self._slot_blocks[slot] = need - len(regs[i])
            else:
                self._slot_blocks[slot] = need
                # one reference a block: all of the row's are reclaimable
                self._h_reclaim[slot] = need
            self._free_blocks[self._slot_shard(slot)] -= need
        self._reclaim_fresh = not self.prefix_cache
        self.peak_resident = max(self.peak_resident, self.active_count)
        return k

    def _read_harvest(self, *more: torch.Tensor):
        """ONE host read per segment: ``done``, the emissions, the
        request ids, the device counters, which slots still prefill,
        ``reclaimable`` (paged), after an admission that registered
        prefix blocks the table that admission left, and ``more``.
        Updates the host mirrors and counters; returns ``done``, the
        emissions, ``n_emitted``, the request ids and ``more``'s
        values. A split pool gathers every shard's (``_host_view``)."""
        p = self.pool
        extra = [p.prefilling]
        kinds = ["rows"] * 4 + ["mine"] + ["rows"] * 4 + \
            ["mine", "sum", "mine", "mine", "rows"]
        paged = self.kv == "paged" and self._kv_key is not None
        if paged:
            extra.append(p.cache[self._kv_key].reclaimable())
            kinds.append("rows")
        if self._unfilled:
            extra.append(self._reg_table)
            kinds.append("table")
        vals = device_loop.read_host(
            p.done, p.out, p.n_emitted, p.request_id, p.launches,
            p.slot_accepted, p.slot_windows, p.slot_layers, p.slot_decodes,
            p.steps, p.slot_steps, p.chunk_steps, p.decode_steps, *extra,
            *more)
        vals = self._host_view(vals, kinds + ["rows"] * len(more))
        self.host_reads += 1
        if more:
            vals, wanted = vals[:-len(more)], vals[-len(more):]
        else:
            wanted = []
        done, out, n_emitted, rids, launches, accepted, windows = vals[:7]
        self._h_depth = np.stack(vals[7:9]).astype(np.int64)
        counts, (prefilling, *rest) = vals[9:13], vals[13:]
        if paged:
            self._h_reclaim[:] = rest.pop(0)
            self._reclaim_fresh = True
        if self._unfilled:
            self._fill_block_ids(rest.pop(0))
        self._h_out[:] = out
        self._h_n_emitted[:] = n_emitted
        self._h_prefilling[:] = prefilling
        self._spec_counts = np.stack([accepted, windows]).astype(np.int64)
        self._counts = np.array([int(c) for c in counts], np.int64)
        # the launches graph segments made since the last harvest (an
        # eager launch was counted in Python when it was made)
        for (o, a), k in zip(_LAUNCH_COUNTERS, launches - self._launches):
            setattr(o, a, getattr(o, a) + int(k))
        self._launches = launches.astype(np.int64)
        if self.prefix_cache:
            # registrations turn READY once their slot has left prefill
            idx = self._prefix_index
            for slot in np.nonzero(self._busy & ~self._h_prefilling)[0]:
                for h, _ in self._slot_regs[slot]:
                    e = idx.entries.get(h)
                    if e is not None:
                        e.ready = True
        return (done, out, n_emitted, rids, *wanted)

    def _harvest(self) -> List[FinishedRequest]:
        """The segment's one read (``_read_harvest``), then the finished
        requests: their slots return to FREE on the host."""
        done, out, n_emitted, rids = self._read_harvest()
        got = []
        for slot in np.nonzero(done)[0]:
            length = int(n_emitted[slot])
            toks = out[slot, :length].copy()
            hit_eos = length > 0 and int(toks[-1]) == self.eos_id
            dl, dt = (int(c) for c in self._h_depth[:, slot])
            got.append(FinishedRequest(
                request_id=int(rids[slot]), tokens=toks, length=length,
                text_length=length - int(hit_eos), hit_eos=hit_eos,
                mean_depth=dl / dt if dt else 0.0))
            self.depth_layers += dl
            self.depth_tokens += dt
            self.tokens_emitted += length
            self._busy[slot] = False
            self._slot_req[slot] = None
            # the device freed these blocks at retirement; the host
            # mirror learns here, before the next admission
            self._free_blocks[self._slot_shard(slot)] += \
                int(self._slot_blocks[slot])
            self._slot_blocks[slot] = 0
            if self.prefix_cache:
                # a done slot's registrations are READY, and it no longer
                # references any entry (its table row was freed)
                self._drop_slot_refs(slot, ready=True)
        return got

    def _fill_block_ids(self, table: np.ndarray) -> None:
        """Registered entries learn their physical block from the table
        their admission left (defensive: a row whose alloc failed maps
        nothing, and its entries leave the index)."""
        idx = self._prefix_index
        for slot in range(self.n_slots):
            kept = []
            for h, c in self._slot_regs[slot]:
                e = idx.entries.get(h)
                if e is None or e.block_id >= 0:
                    kept.append((h, c))
                elif int(table[slot, c]) >= 0:
                    e.block_id = int(table[slot, c])
                    kept.append((h, c))
                else:
                    idx.entries.pop(h)
            self._slot_regs[slot] = kept
        self._unfilled = False

    def _slot_refs(self, slot: int, ready: bool):
        """What the slot's leaving the index's rows does: the keys of
        the registrations that leave the index (PENDING, half-written,
        unless ``ready``), of those that turn READY, and of the hit
        entries; the last two lose the slot's reference."""
        entries = self._prefix_index.entries
        evict, keep = [], []
        for h, _ in self._slot_regs[slot]:
            e = entries.get(h)
            if e is not None:
                (keep if ready or e.ready else evict).append(h)
        hits = [h for h in self._slot_hits[slot] if h in entries]
        return evict, keep, hits

    def _drop_slot_refs(self, slot: int, ready: bool) -> List[int]:
        """The slot leaves the index's rows (``_slot_refs``). Returns the
        evicted entries' block ids."""
        idx = self._prefix_index
        evict, keep, hits = self._slot_refs(slot, ready)
        for h in keep:
            idx.entries[h].ready = True
        for h in keep + hits:
            idx.entries[h].row_refs -= 1
        self.prefix_evictions += len(evict)
        self._slot_regs[slot] = []
        self._slot_hits[slot] = []
        return [idx.evict(h) for h in evict]

    def blocks_freed(self, plan) -> int:
        """Blocks that come back once the resident rows in ``plan`` are
        preempted (``preempt_slots``) and the next admission evicts what
        it may: each row's unpinned blocks, its PENDING registrations
        (evicted with it), and each READY entry whose last row reference
        leaves with the plan (the admission may evict it, a block each;
        an entry the head maps instead needs no fresh block, which
        counts the same). From host state: no read."""
        return int(self._freed_by_shard(plan).sum())

    def _freed_by_shard(self, plan) -> np.ndarray:
        """``blocks_freed`` of each shard."""
        out = np.zeros(self._shards, np.int64)
        for s in plan:
            out[self._slot_shard(s)] += int(self._slot_blocks[s])
        if not self.prefix_cache:
            return out
        evicted, refs = {}, collections.Counter()
        for s in plan:
            evict, keep, hits = self._slot_refs(
                s, ready=not self._h_prefilling[s])
            # a registration's block lives in its row's shard
            evicted.update((h, self._slot_shard(s)) for h in evict)
            refs.update(keep + hits)
        for r in evicted.values():
            out[r] += 1
        entries = self._prefix_index.entries
        for h, n in refs.items():
            e = entries[h]
            if h not in evicted and e.block_id >= 0 and e.row_refs == n:
                out[self._block_shard(e.block_id)] += 1
        return out

    def fits(self, need: int, plan=()) -> bool:
        """Would a request holding ``need`` blocks be admitted once the
        resident rows in ``plan`` are preempted: a free slot in a shard
        with ``need`` free blocks (off a mesh: a free slot and ``need``
        free blocks). From host state: no read; the SLO layer and the
        disaggregated router gate on it."""
        slots = np.zeros(self._shards, np.int64)
        for s in np.nonzero(~self._busy)[0]:
            slots[self._slot_shard(s)] += 1
        for s in plan:
            slots[self._slot_shard(s)] += 1
        blocks = self._free_blocks + self._freed_by_shard(plan)
        return bool(((slots >= 1) & (blocks >= need)).any())

    def slot_leader(self, slot: int) -> int:
        """The global rank that holds ``slot``'s row and speaks for it
        (the lowest of its replicas); 0 off a mesh."""
        if self.mesh is None:
            return 0
        if self._shards == 1:
            return int(self.mesh.mesh.min())
        return sh.shard_leader(self.mesh, self._axes,
                               self._slot_shard(slot))

    def export_slot(self, slot: int, n_cols: int):
        """The K/V behind ``slot``'s leading ``n_cols`` table columns as
        fresh wire buffers (``PagedKVCache.export_rows``), on a rank that
        holds the row; None on the others."""
        r = self._slot_shard(slot)
        if r != self._shard:
            return None
        rows = torch.full((1,), slot - r * self._n_loc, dtype=torch.int64,
                          device=self.device)          # a fill: no copy
        return self.pool.cache[self._kv_key].export_rows(rows, n_cols)

    @contextlib.contextmanager
    def _on_device(self):
        """The scheduler's device and stream made current, autograd off:
        a front-end steps the scheduler from a worker thread, whose
        current stream is not the one the scheduler captured beside."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            if self._stream is not None:
                stack.enter_context(torch.cuda.device(self.device))
                stack.enter_context(torch.cuda.stream(self._stream))
            yield

    def dispatch_segment(self, expect_arrivals: bool = False,
                         max_steps: Optional[int] = None) -> bool:
        """Admit, then launch one segment without reading the device (the
        first half of ``step``). With an empty queue the segment drains
        (retirements do not pause it) unless ``expect_arrivals``: then it
        returns as soon as a slot frees, so a request arriving mid-drain
        is admitted promptly. ``max_steps`` additionally caps its
        iterations (None: no cap). Returns False when nothing ran (an
        idle pool). The disaggregated router launches the prefill tier's
        segment this way and polls ``segment_done``."""
        with self._on_device():
            if self._graph and self._loop is None and not self._busy.any():
                self._capture()
            self._admit_queued()
            if self.active_count == 0:
                return False
            if not self.queue and not expect_arrivals:
                want = self.n_slots + 1          # drain: never pause
            else:
                # return once enough slots have freed beyond those idle
                # at entry (idle slots the queue could not fill do not
                # count)
                fresh = (min(self.admit_threshold, len(self.queue))
                         if self.queue else self.admit_threshold)
                want = self.free_slots + fresh
            self._segment(want, _NO_STEP_CAP if max_steps is None
                          else int(max_steps))
            if self._seg_event is not None:
                self._seg_event.record(self._stream)
        return True

    def segment_done(self) -> bool:
        """Has the last launched segment finished? A poll of an event
        recorded after it, which does not wait (always True on the
        CPU, where the segment ran in the call)."""
        return self._seg_event is None or self._seg_event.query()

    def step(self, expect_arrivals: bool = False,
             max_steps: Optional[int] = None) -> List[FinishedRequest]:
        """One scheduling round: admit -> segment -> harvest
        (``dispatch_segment``'s arguments): a streaming or SLO layer
        takes control back every few iterations with ``max_steps`` to
        surface tokens and revisit preemption. A prefill-only tier
        returns [] without a read: collect its rows with
        ``harvest_prefilled``."""
        if not self.dispatch_segment(expect_arrivals, max_steps) or \
                self.prefill_only:
            return []
        with self._on_device():
            return self._harvest()

    # ---------------- preemption (the SLO layer's mechanism) -----------

    def resident(self) -> Dict[int, np.ndarray]:
        """{request id: tokens emitted so far} of every resident request,
        as of the last harvest."""
        return {q.request_id: self.emitted(s)
                for s, q in enumerate(self._slot_req) if q is not None}

    def emitted(self, slot: int) -> np.ndarray:
        """The tokens a resident slot has emitted, as of the last harvest
        (exact between rounds)."""
        return self._h_out[slot, :int(self._h_n_emitted[slot])].copy()

    def reclaimable_host(self) -> np.ndarray:
        """``reclaimable()`` of the paged pool on the host (zeros for a
        dense cache): the harvest's copy, kept exact by admission, splice
        and preemption without the prefix cache; with it, a read of its
        own (counted in ``host_reads``) after an admission or preemption
        since the last harvest."""
        if self.kv != "paged" or self._kv_key is None:
            return np.zeros(self.n_slots, np.int64)
        if not self._reclaim_fresh:
            with self._on_device():
                (rec,) = self._host_view(device_loop.read_host(
                    self.pool.cache[self._kv_key].reclaimable()), ["rows"])
            self.host_reads += 1
            self._h_reclaim[:] = rec
            self._reclaim_fresh = True
        return self._h_reclaim.copy()

    def preempt_slots(self, slots) -> List[PreemptedRequest]:
        """Evict resident requests from ``slots``, between segments,
        freeing their blocks; returns each as a ``PreemptedRequest`` to
        re-queue (``resubmit``) for recompute-from-prompt. The emitted
        tokens come from the host mirrors (the last harvest's read, kept
        exact by admission). READY registrations keep their pins (the
        replay maps them back); PENDING ones leave the index, their pins
        released in the same call that frees the rows."""
        slots = sorted({int(s) for s in np.atleast_1d(
            np.asarray(slots, np.int64))})
        if not slots:
            return []
        for s in slots:
            if not 0 <= s < self.n_slots or not self._busy[s]:
                raise ValueError(f"slot {s} is not resident")
        evict = None
        with self._on_device():
            if self.prefix_cache:
                if self._unfilled:
                    # an admission since the last harvest registered
                    # blocks: their ids are read here, the one read
                    # beyond the harvest
                    (table,) = self._host_view(
                        device_loop.read_host(self._reg_table), ["table"])
                    self.host_reads += 1
                    self._fill_block_ids(table)
                evicted: List[int] = []
                for s in slots:
                    evicted += self._drop_slot_refs(
                        s, ready=not self._h_prefilling[s])
                evict = torch.from_numpy(self._local_blocks(
                    evicted, self._kv_loc)).to(self.device)
                # each evicted pin was its block's last reference beside
                # the row's own (freed below): fully free again
                for b in evicted:
                    self._free_blocks[self._block_shard(b)] += 1
            self._preempt(self._local_mask(slots), evict)
        got: List[PreemptedRequest] = []
        for s in slots:
            q = self._slot_req[s]
            got.append(PreemptedRequest(
                request_id=q.request_id, prompt=q.prompt,
                max_new=q.max_new, key=q.key, tokens=self.emitted(s),
                priority=q.priority, deadline=q.deadline,
                prefix_embeds=q.prefix_embeds, frames=q.frames))
            self._busy[s] = False
            self._slot_req[s] = None
            self._h_n_emitted[s] = 0
            self._h_depth[:, s] = 0
            self._h_prefilling[s] = False
            self._free_blocks[self._slot_shard(s)] += \
                int(self._slot_blocks[s])
            self._slot_blocks[s] = 0
            self._h_reclaim[s] = 0
        # shared blocks change other rows' counts: read them when needed
        self._reclaim_fresh = self._reclaim_fresh and not self.prefix_cache
        self.preemptions += len(slots)
        return got

    # ---------------- disaggregation hooks (serve/disagg.py) ----------

    def harvest_prefilled(self) -> List[dict]:
        """Prefill-only tier: the rows whose prompt completed in the last
        segment, from the segment's ONE read (``done``, the first
        tokens and the prompt lengths come with the harvest's): one
        record per row, ``slot``, the host-side request ``req``, the
        first sampled token ``t0`` and the prefilled length ``plen``.
        Frees nothing: the rows keep backing the blocks the caller
        exports; ``release_slots`` frees them, before the next segment
        (whose entry clears ``done``)."""
        if not self.prefill_only:
            raise RuntimeError("harvest_prefilled() requires a "
                               "prefill_only=True scheduler")
        with self._on_device():
            done, _, _, _, t0, plen = self._read_harvest(
                self.pool.next_token, self.pool.plen)
        return [{"slot": int(s), "req": self._slot_req[int(s)],
                 "t0": int(t0[s]), "plen": int(plen[s])}
                for s in np.nonzero(done)[0]]

    def release_slots(self, slots) -> None:
        """Free harvested prefill rows (their blocks and registers) once
        their blocks are exported, in place between segments (the
        preemption's device op). Prefix-index registrations turn READY
        and keep their pins, as at retirement."""
        slots = sorted({int(s) for s in np.atleast_1d(
            np.asarray(slots, np.int64))})
        if not slots:
            return
        for s in slots:
            if not 0 <= s < self.n_slots or not self._busy[s]:
                raise ValueError(f"slot {s} is not resident")
        with self._on_device():
            self._preempt(self._local_mask(slots), None)
        for s in slots:
            self._busy[s] = False
            self._slot_req[s] = None
            self._free_blocks[self._slot_shard(s)] += \
                int(self._slot_blocks[s])
            self._slot_blocks[s] = 0
            self._h_reclaim[s] = 0
            self._h_prefilling[s] = False
            if self.prefix_cache:
                self._drop_slot_refs(s, ready=True)
        self._reclaim_fresh = self._reclaim_fresh and not self.prefix_cache

    def splice_requests(self, reqs: List[_Queued], t0s, plens, k_data,
                        v_data, ready=None) -> List[int]:
        """Admit already-prefilled requests into free slots (the decode
        tier of a disaggregated deployment): free and allocate each row
        for ``plen + max_new + 1`` positions, import the shipped blocks
        ``k_data``/``v_data`` ``(L, len(reqs), n_cols, block, KV, hd)``
        into its leading table columns, and register it RUNNING with
        ``cur_len = plen + 1``, ``t0`` pending and nothing emitted. One
        host-to-device write (the registers, packed) and no read.
        ``ready``: a CUDA event after which the shipment is complete (the
        scheduler's stream waits for it). The caller gates on
        ``free_slots`` and ``free_blocks``. Returns the slots filled."""
        if not self._chunked or self.kv != "paged" or self.prefill_only:
            raise RuntimeError(
                "splice_requests needs prefill='chunked', kv='paged' and "
                "prefill_only=False (the disaggregated decode tier)")
        k = len(reqs)
        if k == 0:
            return []
        if k_data.shape[1] != k or k > self.free_slots:
            raise RuntimeError(
                f"splice of {k} requests needs {k} free slots and a "
                f"matching shipment; free={self.free_slots}, shipment "
                f"rows={k_data.shape[1]}")
        needs = [self.blocks_for(int(plens[i]), reqs[i].max_new)
                 for i in range(k)]
        # each request in the lowest free slot whose shard has its blocks
        blocks_free = self._free_blocks.copy()
        chosen: List[int] = []
        for need in needs:
            fit = [s for s in self._free_slot_order(chosen)
                   if blocks_free[self._slot_shard(s)] >= need]
            if not fit:
                raise RuntimeError(
                    f"splice needs {need} blocks in a shard with a free "
                    f"slot; free per shard={self._free_blocks.tolist()} "
                    f"(the caller gates admission with fits())")
            chosen.append(fit[0])
            blocks_free[self._slot_shard(fit[0])] -= need
        n, L = self.n_slots, self.prompt_len
        free = chosen + [int(s) for s in np.nonzero(~self._busy)[0]
                         if int(s) not in chosen]
        slots = np.asarray(free + [int(s) for s in
                                   np.nonzero(self._busy)[0]])
        rows, local_slots, local_mask = self._local_rows(slots, k)
        # the registers of all n rows in one int64 buffer (and a default
        # row n): prompt, plen, slot, rid, max_new, key words, derive,
        # mask, priority, t0 and the deadline's float32 bits
        host = np.zeros((n + 1, L + 11), np.int64)
        host[:, L] = L
        host[:, L + 2] = -1
        host[:, L + 10] = np.float32(np.inf).view(np.int32)
        for i, q in enumerate(reqs):
            tl = q.prompt.shape[1]
            host[i, :tl] = q.prompt[0]
            host[i, L] = int(plens[i])
            host[i, L + 2] = q.request_id
            host[i, L + 3] = q.max_new
            if q.key is None:
                host[i, L + 6] = 1
            else:
                host[i, L + 4:L + 6] = q.key
            host[i, L + 7] = 1
            host[i, L + 8] = q.priority
            host[i, L + 9] = int(t0s[i])
            host[i, L + 10] = np.float32(q.deadline).view(np.int32)
        host = host[rows]
        host[:, L + 1] = local_slots
        mine = rows[local_mask]        # this shard's shipment rows
        with self._on_device():
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            if len(mine) == 0:
                host = None                  # nothing lands in this shard
        if host is not None:
            self._splice_local(host, mine, k_data, v_data)
        filled = []
        for i, q in enumerate(reqs):
            slot = chosen[i]
            self._busy[slot] = True
            self._slot_req[slot] = q
            self._slot_blocks[slot] = needs[i]
            self._h_reclaim[slot] = needs[i]
            self._free_blocks[self._slot_shard(slot)] -= needs[i]
            self._h_n_emitted[slot] = 0
            self._h_depth[:, slot] = 0
            self._h_prefilling[slot] = False
            filled.append(slot)
        self.peak_resident = max(self.peak_resident, self.active_count)
        return filled

    def _splice_local(self, host, mine, k_data, v_data) -> None:
        """The splice's device work in this shard: ``host`` the packed
        registers of its rows (its admitted rows first), ``mine`` their
        rows of the shipment."""
        L, m = self.prompt_len, len(mine)
        if list(mine) != list(range(k_data.shape[1])):
            sel = torch.as_tensor(mine, dtype=torch.long,
                                  device=k_data.device)
            k_data, v_data = k_data[:, sel], v_data[:, sel]
        with self._on_device():
            d = torch.from_numpy(host)
            if self._stream is not None:
                d = d.pin_memory()
            d = d.to(self.device, non_blocking=True)
            i32 = d.to(torch.int32)
            prompts, plen, slot_ix = i32[:, :L], i32[:, L], i32[:, L + 1]
            rids, max_news = i32[:, L + 2], i32[:, L + 3]
            keys, derive = d[:, L + 4:L + 6], d[:, L + 6].bool()
            mask, prios, t0 = d[:, L + 7].bool(), i32[:, L + 8], i32[:, L + 9]
            deadlines = i32[:, L + 10].contiguous().view(torch.float32)
            self._reserve(slot_ix, plen + max_news + 1, mask)
            self.pool.cache[self._kv_key].import_rows(
                slot_ix[:m], k_data.to(self.device),
                v_data.to(self.device), mask=mask[:m])
            zeros = torch.zeros_like(rids)
            self._register(slot_ix, mask, next_token=t0, cur_len=plen + 1,
                           n_emitted=zeros, budget=max_news,
                           active=torch.ones_like(mask), done=zeros.bool(),
                           request_id=rids,
                           keys=self._request_keys(rids, keys, derive),
                           out=torch.zeros_like(self.pool.out),
                           prompt=prompts, plen=plen, pf_pos=plen,
                           prefilling=zeros.bool(), priority=prios,
                           deadline=deadlines, slot_layers=zeros,
                           slot_decodes=zeros)

    def resubmit(self, p: PreemptedRequest) -> None:
        """Re-queue a preempted request at the FRONT of the queue with
        its id, key, priority and deadline: the replay regenerates the
        same stream from the prompt."""
        self.queue.insert(0, _Queued(p.request_id, p.prompt, p.max_new,
                                     p.key, p.priority, p.deadline,
                                     p.prefix_embeds, p.frames))

    def run_until_drained(self) -> List[FinishedRequest]:
        """Drive until queue and pool are empty; returns all finished."""
        results: List[FinishedRequest] = []
        while self.pending:
            before = self.pending
            results.extend(self.step())
            if self.pending == before:
                raise RuntimeError("scheduler made no progress")
        return results

    def reset_stats(self) -> None:
        """Zero the run counters. Called automatically when work is
        submitted to a fully idle, fully drained scheduler, i.e. at the
        start of each new run, so back-to-back ``run_until_drained``
        calls each report their own counters. Manual ``step()`` driving
        mid-run is unaffected: the scheduler is not idle then."""
        p = self.pool
        with self._on_device():
            for t in (p.steps, p.slot_steps, p.chunk_steps, p.decode_steps,
                      p.launches, p.slot_accepted, p.slot_windows,
                      p.slot_layers, p.slot_decodes):
                t.zero_()
        self._counts[:] = 0
        self._launches[:] = 0
        self._spec_counts[:] = 0
        self._h_depth[:] = 0
        self.depth_layers = self.depth_tokens = 0
        self.tokens_emitted = 0
        self.host_reads = self.segments = self.graph_replays = 0
        self.prefix_hit_blocks = self.prefix_evictions = 0
        self.cross_rank_block_copies = 0
        self.peak_resident = self.preemptions = 0

    @property
    def total_steps(self) -> int:
        """Loop iterations (as of the last harvest)."""
        return int(self._counts[0])

    @property
    def busy_slot_steps(self) -> int:
        """Decoding slots summed over the loop's iterations."""
        return int(self._counts[1])

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots decoding over all loop iterations
        (prefill-only iterations count as idle decode capacity)."""
        if self.total_steps == 0:
            return 0.0
        return self.busy_slot_steps / (self.total_steps * self.n_slots)

    # Speculation, as of the last harvest. Emission-weighted, as in the
    # JAX package: a window's accepted count is the tokens it emitted
    # beyond one (after the EOS and budget cuts).

    @property
    def spec_windows(self) -> int:
        """Verify windows run, summed over slots (0 without speculation)."""
        return int(self._spec_counts[1].sum())

    @property
    def accepted_tokens(self) -> int:
        """Tokens emitted beyond one a verify window, summed."""
        return int(self._spec_counts[0].sum())

    @property
    def drafted_tokens(self) -> int:
        """Drafted candidates, k a verify window."""
        return self.spec_windows * (self.speculative.k
                                    if self.speculative else 0)

    @property
    def accept_rate(self) -> float:
        """accepted_tokens / drafted_tokens (0.0 when nothing drafted)."""
        d = self.drafted_tokens
        return self.accepted_tokens / d if d else 0.0

    @property
    def mean_accept_len(self) -> float:
        """Mean accepted drafts a verify window (tokens an iteration is
        this + 1)."""
        w = self.spec_windows
        return self.accepted_tokens / w if w else 0.0

    def slot_accept_len(self) -> np.ndarray:
        """Per-slot mean accept length over that slot's windows."""
        a, w = self._spec_counts.astype(np.float64)
        return a / np.maximum(w, 1.0)

    # Adaptive depth, as of the last harvest (no read of its own).

    @property
    def mean_depth(self) -> float:
        """Mean decoder blocks applied a decode token over the run: the
        harvested requests' totals plus the resident slots' counters.
        ``n_layers`` without adaptive depth; less where early exit or
        mixture-of-depths skipped blocks (``models.adaptive``)."""
        res = self._h_depth[:, self._busy].sum(axis=1)
        dt = self.depth_tokens + int(res[1])
        return (self.depth_layers + int(res[0])) / dt if dt else 0.0

    def slot_mean_depth(self) -> np.ndarray:
        """Per-slot mean depth over that slot's current residency (the
        counters restart at admission)."""
        a, d = self._h_depth.astype(np.float64)
        return a / np.maximum(d, 1.0)

    @property
    def depth_impl(self) -> str:
        """Which lowering runs the decode layer loop: "static",
        "cuda-graph:if-per-layer" or "host-read"
        (``transformer.depth_impl``)."""
        return transformer.depth_impl(self.cfg, self._graph)

    @property
    def attn_impl(self) -> str:
        return engine.resolved_attn_impl(
            self.cfg, self.kv, self.device,
            verify=self.speculative is not None)

    @property
    def prefill_impl(self) -> str:
        return engine.resolved_prefill_impl(self.cfg, self.kv, self.prefill,
                                            self.device)

    @property
    def device_launches(self) -> Dict[str, int]:
        """Launches inside this scheduler's graph segments since the run
        began, counted on the device, as of the last harvest: one entry
        for each of ``paged_attention``, ``flash_prefill``, ``gather``
        and ``flash_verify`` (zeros under the host-read loop, whose
        launches the wrappers count in Python)."""
        return {k: int(v) for k, v in zip(_COUNTED, self._launches)}

    @property
    def pool_layout(self) -> str:
        """How the pool lies on the mesh: "single" (no mesh, or a mesh of
        one), "sharded:<axes>x<D>" (each data shard holds n_slots / D
        slots) or "replicated" (every rank the whole pool)."""
        if not self._meshed:
            return "single"
        if self._shards > 1:
            return f"sharded:{','.join(self._axes)}x{self._shards}"
        return "replicated"

    @property
    def model_layout(self) -> str:
        """How the weights and the cache lie on the mesh's model axis:
        "single" (no mesh, or no model axis of more than one device) or
        "split:modelx<m>" (each rank its slices of the weights, its K/V
        heads and its SSM channels, module docstring)."""
        if self._model == 1:
            return "single"
        return f"split:modelx{self._model}"

    @property
    def transfer_impl(self) -> str:
        """How prefilled K/V reaches the decode kernel: here it never
        leaves the pool (the disaggregated router names its copy)."""
        return "colocated"


def _noop() -> None:
    """The untaken side of a branch: the pool is updated in place."""
