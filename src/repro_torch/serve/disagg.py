"""Prefill/decode disaggregation: a two-tier router over a prefill
scheduler and a decode scheduler, with the finished prompts' KV blocks
shipped between their pools, in one process on one card or on disjoint
slices of a fleet of ranks.

Port of ``repro/serve/disagg.py``. The JAX package puts the two tiers on
disjoint submeshes of a device fleet and ships blocks with an async
``jax.device_put``. In one process (``prefill_mesh=None``,
``decode_mesh=None``) both tiers share the card's memory and its SMs,
and a shipment is a device copy:

- the **prefill tier**, a ``DecodeScheduler`` with ``prefill_only=True``
  (chunked ``flash_prefill`` admission into a paged pool): a row whose
  prompt completes retires holding its blocks and its first token;
- the **decode tier**, a second scheduler that never prefills: it admits
  prefilled requests with ``splice_requests`` and decodes through the
  ``paged_attention`` kernel.

The ship. After the prefill tier's harvest, ``PagedKVCache.export_rows``
gathers a row's blocks into a fresh wire buffer ``(L, 1, n_cols, block,
KV, hd)`` on a side stream, which first waits for the prefill tier's
stream, and an event is recorded there; the prefill tier's stream waits
for that event before its rows are released (their blocks may then be
recycled). The splice, in a later round, makes the decode tier's stream
wait for the event and imports the buffer
(``PagedKVCache.import_rows``), and the buffer is marked as used on that
stream so that the allocator keeps it until the import has run. This is
the counterpart of JAX's data dependency on the ``device_put``: nothing
on the host waits for a shipment. ``transfer_impl`` names the path
(``cuda-copy:side-stream``; ``torch-copy:cpu`` on the CPU, where the
copy runs in the call).

Both tiers read the one set of weights on the card: with ``mesh=None``
the reference hands both tiers the same parameters too, and a copy would
only double their memory.

On a fleet (``prefill_mesh``/``decode_mesh``: two ``DeviceMesh`` over
disjoint ranks of the default group, ``sharding.carve_slices`` and
``slice_mesh``), every rank of the two slices builds the router, and
each tier's scheduler is built only on its slice's ranks, with that
slice's rules (``_slice_rules``) and mesh, so its pool lies on its
slice (``DecodeScheduler(rules=, mesh=)``) and reads the rank's own
replica of the weights. The router runs alike on every rank
(``_step_mesh``): a round feeds the prefill tier, runs its segment and
harvests it on the prefill slice while the decode slice splices earlier
rounds' shipments (preempting for an urgent head) and runs its segment;
then one gather (``_exchange``) tells every rank the round's facts, the
prefill slice's leader's (how many it admitted, the harvested rows with
``t0``, ``plen`` and the rank that holds each row) and the decode
slice's leader's (what it spliced, its preemption victims, what
finished, its counts), which each rank applies in the single-process
order. Then each harvested row's wire buffer goes from the prefill rank
that holds it to every decode rank in one broadcast in a group of the
two (``_wire``: through pinned host memory under gloo, which carries no
CUDA tensor in point-to-point ops, ``bcast:gloo-host``; from the device
under NCCL, ``bcast:nccl``), and splices strictly one round later, as
in the reference. ``transfer_ms`` keeps the decode leader's host wall of
each shipment's broadcasts. A launcher admits on the fleet's first
rank's clock (``agree``).

Kept from the reference: the priority backlog (sorted by priority,
deadline, request id); the rule that a shipment dispatched in a round
splices only in a later one (``_splice_arrivals``); decode-tier
preemption of strictly lower-priority residents when the most urgent
shipment does not fit, the victims re-queued for recompute through the
prefill tier and their replayed streams held to the preemption
snapshots (``replay_mismatches``); the n-gram drafter only (a model
drafter's dense cache would also have to ship); the prefix cache on the
prefill tier only (the decode tier receives private copies); and the
counters. The victim order reads the decode tier's host mirrors
(``reclaimable_host``, the emissions), exact there because the decode
tier holds no prefix cache, so each tier makes one host read a segment:
its harvest. The prefill tier's segment is launched without a read
(``dispatch_segment``) and polled (``segment_done``, an event query)
while the decode tier has residents to serve.

Greedy streams equal the colocated scheduler's: the splice registers the
state a colocated slot holds the moment its last chunk completes
(``cur_len = plen + 1``, the first token sampled from the final chunk's
logits at emission index 0), and both tiers derive request keys from the
same seed.

Whether the two tiers' segments overlap on the card's SMs (each tier
works on its own stream) is measured, not assumed: the reference's
inter-token win for running slots comes from disjoint devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..dist import sharding as sh
from ..models import model_zoo
from . import engine
from . import kv_cache as kvc
from . import sampling as sampling_lib
from . import scheduler as sched_lib

__all__ = ["DisaggScheduler"]



def _slice_rules(cfg, mesh):
    """``ShardingRules`` for one slice mesh (None off a mesh)."""
    return None if mesh is None else model_zoo.make_rules(cfg, mesh)


def _ranks(mesh) -> List[int]:
    return [int(r) for r in mesh.mesh.reshape(-1).tolist()]


@dataclasses.dataclass
class _Shipment:
    """One request's KV blocks in flight between the tiers."""

    req: sched_lib._Queued   # the original record (its real max_new)
    t0: int                  # the first token, sampled on the prefill tier
    plen: int                # the prefilled stream length
    k: Any                   # (L, 1, n_cols, block, KV, hd) wire buffers
    v: Any
    round: int               # the dispatch round: spliced strictly later
    ready: Optional[torch.cuda.Event] = None   # the export has run
    timing: Optional[tuple] = None             # (start, end) timing events


class DisaggScheduler:
    """Two-tier router over a prefill tier and a decode tier, in one
    process or on disjoint slices of a fleet.

    Args:
      params, cfg: the model; both tiers read these parameters.
      n_prefill_slots / n_decode_slots: each tier's slots. The prefill
        tier turns a slot over once a prompt, so it runs much smaller.
      prompt_len, max_new_cap, eos_id, sampling, seed: as the colocated
        scheduler's; ``seed`` is shared by the tiers (both derive request
        keys from it).
      prefill_mesh / decode_mesh: both None (both tiers in this
        process), or two ``DeviceMesh`` over disjoint ranks of the
        default group (``sharding.carve_slices``/``slice_mesh``): every
        rank of the two builds the router, and each tier's scheduler is
        built only on its slice's ranks (module docstring).
      kv_block, chunk_tokens: block and chunk geometry (shared: the wire
        format is block-granular).
      prefill_kv_blocks / decode_kv_blocks: each tier's pool.
      prefix_cache: prompt-block sharing on the prefill tier.
      prefix_len: a VLM deployment's patch prefix (``cfg.n_patches``;
        every request then brings ``prefix_embeds``), else 0. The
        prefill tier prefills the patches with the prompt; the decode
        tier sees the prefilled stream, patches included, as its
        prompt (its ``prompt_len`` is ``prompt_len + prefix_len``), so
        its positions match a colocated pool's.
      speculative / draft_params / draft_cfg: decode-tier speculation,
        the n-gram drafter only.
      segment_steps: the decode segment's iteration cap while the prefill
        pipeline is live (the splice and preemption revisit interval).
      prefill_segment_steps: the prefill segment's cap (default
        ``segment_steps``).
    """

    def __init__(self, params, cfg, *, n_prefill_slots: int,
                 n_decode_slots: int, prompt_len: int, max_new_cap: int,
                 eos_id: int = 1,
                 sampling: sampling_lib.SamplingParams =
                 sampling_lib.SamplingParams(),
                 prefill_mesh=None, decode_mesh=None, seed: int = 0,
                 kv_block: int = 16,
                 prefill_kv_blocks: Optional[int] = None,
                 decode_kv_blocks: Optional[int] = None,
                 chunk_tokens: int = 16, prefix_cache: bool = False,
                 speculative=None, draft_params=None, draft_cfg=None,
                 segment_steps: int = 8,
                 prefill_segment_steps: Optional[int] = None,
                 prefix_len: int = 0):
        if (prefill_mesh is None) != (decode_mesh is None):
            raise ValueError("pass both prefill_mesh and decode_mesh (two "
                             "disjoint slices), or neither")
        if segment_steps < 1:
            raise ValueError("segment_steps must be >= 1")
        if prefill_segment_steps is not None and prefill_segment_steps < 1:
            raise ValueError("prefill_segment_steps must be >= 1")
        if speculative is not None and (draft_cfg is not None
                                        or draft_params is not None):
            raise ValueError(
                "disaggregation supports the n-gram drafter only: a "
                "model drafter keeps a dense per-slot draft cache that "
                "would also need shipping between the tiers")
        self.cfg = cfg
        self.prefix_len = int(prefix_len)
        self.prompt_len, self.max_new_cap = int(prompt_len), int(max_new_cap)
        self.segment_steps = int(segment_steps)
        self.prefill_segment_steps = int(prefill_segment_steps
                                         or segment_steps)
        self.prefill_mesh, self.decode_mesh = prefill_mesh, decode_mesh
        self._meshed = prefill_mesh is not None
        self._role = "both"
        if self._meshed:
            for m in (prefill_mesh, decode_mesh):
                if sh.mesh_shape(m).get("model", 1) > 1:
                    raise ValueError(
                        "a disaggregated tier's slice must be data-only: "
                        "the wire ships a row's whole K/V heads, which a "
                        "model axis splits over the slice's ranks")
            self._join_fleet(prefill_mesh, decode_mesh)
        # one wire shape for every prompt: columns for the longest
        self.ship_cols = int(kvc.blocks_needed(prompt_len + self.prefix_len,
                                               kv_block))
        dev = params["embed"].device
        self.device = dev
        self.prefill = self.decode = None
        if self._role in ("both", "prefill"):
            # max_new_cap=1 sizes the prefill pool to prompts;
            # prefill_only retires rows instead of decoding them. In one
            # process the prefill tier works on a stream of its own (the
            # scheduler keeps the stream current when it is built), so
            # that its segments may overlap the decode tier's on the card.
            pf_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                         and not self._meshed else None)
            with (torch.cuda.stream(pf_stream) if pf_stream is not None
                  else contextlib.nullcontext()):
                self.prefill = sched_lib.DecodeScheduler(
                    params, cfg, n_slots=n_prefill_slots,
                    prompt_len=prompt_len, max_new_cap=1, eos_id=eos_id,
                    sampling=sampling, seed=seed, kv="paged",
                    kv_block=kv_block, kv_blocks=prefill_kv_blocks,
                    prefill="chunked", chunk_tokens=chunk_tokens,
                    prefix_cache=prefix_cache, prefill_only=True,
                    prefix_len=self.prefix_len,
                    rules=_slice_rules(cfg, prefill_mesh),
                    mesh=prefill_mesh)
        if self._role in ("both", "decode"):
            self.decode = sched_lib.DecodeScheduler(
                params, cfg, n_slots=n_decode_slots,
                prompt_len=prompt_len + self.prefix_len,
                max_new_cap=max_new_cap, eos_id=eos_id, sampling=sampling,
                seed=seed, kv="paged", kv_block=kv_block,
                kv_blocks=decode_kv_blocks, prefill="chunked",
                chunk_tokens=chunk_tokens, speculative=speculative,
                rules=_slice_rules(cfg, decode_mesh), mesh=decode_mesh)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" and not self._meshed
                      else None)
        # the request checks of the tier this rank may not hold
        self._kv_block = int(kv_block)
        self._decode_kv_blocks = (
            n_decode_slots * int(kvc.blocks_needed(
                prompt_len + self.prefix_len + max_new_cap + 1, kv_block))
            if decode_kv_blocks is None else int(decode_kv_blocks))
        self._next_rid = 0
        # what the other slice told this rank in the last round's
        # exchange (``_exchange``), and the transfer times measured here
        self._facts: Dict[str, Any] = {}
        self._victims: List[tuple] = []
        self.transfer_ms: List[float] = []
        # router state
        self.queue: List[sched_lib._Queued] = []   # the priority backlog
        self._in_transit: List[_Shipment] = []
        self._orig_max_new: Dict[int, int] = {}
        self._snapshots: Dict[int, np.ndarray] = {}
        self._pending_feed: List[sched_lib._Queued] = []   # prefilling
        self._round = 0
        self._prefill_inflight = False   # a launched, unharvested segment
        self._export_events: List[tuple] = []
        self.reset_stats()

    # ---------------- the fleet (tiers on disjoint slices) -------------

    def _join_fleet(self, prefill_mesh, decode_mesh) -> None:
        """This rank's role, the group the router's exchange runs in, and
        one group a prefill rank to carry its shipments to the decode
        slice (every rank of the fleet creates them, in one order)."""
        import torch.distributed as dist
        pf, de = _ranks(prefill_mesh), _ranks(decode_mesh)
        if set(pf) & set(de):
            raise ValueError(f"the tiers' slices must be disjoint; prefill "
                             f"ranks {pf}, decode ranks {de}")
        fleet = sorted(pf + de)
        me = dist.get_rank()
        if me not in fleet:
            raise ValueError(f"rank {me} is in neither slice")
        self._pf_ranks, self._de_ranks = pf, de
        self._role = "prefill" if me in pf else "decode"
        self._group = (None if fleet == list(range(dist.get_world_size()))
                       else dist.new_group(fleet))
        self._wires = {p: dist.new_group([p] + de) for p in pf}
        self._backend = dist.get_backend()

    def _exchange(self, facts: dict) -> List[dict]:
        """Every fleet rank's facts of this round, in one gather (the
        slices' leaders speak; the others send None)."""
        import torch.distributed as dist
        got = [None] * (len(self._pf_ranks) + len(self._de_ranks))
        dist.all_gather_object(got, facts, group=self._group)
        return got

    def agree(self, value):
        """``value`` as the fleet's first rank has it (a clock reading that
        decides arrivals, say); the value itself off a mesh."""
        if not self._meshed:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=min(self._pf_ranks
                                                + self._de_ranks),
                                   group=self._group)
        return box[0]

    def _wire(self, owner: int, k, v):
        """Carry one shipment's buffers from ``owner`` (a prefill rank) to
        every decode rank: a broadcast in the group of the two, through
        host memory under gloo (which carries no CUDA tensor in
        point-to-point ops; a pinned copy on each side), straight from
        the device under NCCL. Returns the buffers on a decode rank (on
        the host under gloo), None elsewhere; the decode leader times
        it."""
        import time
        import torch.distributed as dist
        cfg, shape = self.cfg, self._wire_shape()
        host = self._backend == "gloo"
        me = dist.get_rank()
        if me != owner and me not in self._de_ranks:
            return None                   # another prefill rank's row
        t0 = time.perf_counter()
        out = []
        for buf in (k, v):
            if me == owner:
                buf = buf.cpu() if host else buf.contiguous()
            else:
                buf = torch.empty(shape, dtype=cfg.dtype("compute"),
                                  device="cpu" if host else self.device)
            if host and buf.device.type == "cpu" and \
                    self.device.type == "cuda":
                buf = buf.pin_memory()
            dist.broadcast(buf, src=owner, group=self._wires[owner])
            out.append(buf)
        if me == self._de_ranks[0]:
            self.transfer_ms.append((time.perf_counter() - t0) * 1e3)
        return None if me in self._pf_ranks else tuple(out)

    def _step_mesh(self, expect_arrivals: bool,
                   max_steps: Optional[int]
                   ) -> List[sched_lib.FinishedRequest]:
        """One round on disjoint slices (``step``'s order, each tier on its
        own ranks): the prefill slice feeds its tier, runs a segment and
        harvests it; the decode slice splices earlier rounds' shipments
        (preempting for an urgent head) and runs a segment; then one
        exchange tells every rank the round's facts, which each applies
        alike, and this round's shipments go out on the wire, to splice
        in a later round."""
        self._round += 1
        self.queue.sort(key=lambda q: (q.priority, q.deadline,
                                       q.request_id))
        facts: Dict[str, Any] = {}
        finished: List[sched_lib.FinishedRequest] = []
        if self.prefill is not None:
            feed = [dataclasses.replace(q, max_new=1) for q in self.queue]
            self.prefill.queue.extend(feed)
            launched = self.prefill.dispatch_segment(
                expect_arrivals=True, max_steps=self.prefill_segment_steps)
            n_admitted = len(feed) - len(self.prefill.queue)
            self.prefill.queue.clear()
            recs = self.prefill.harvest_prefilled() if launched else []
            facts = {"n_admitted": n_admitted, "recs": [
                (r["slot"], r["req"].request_id, r["t0"], r["plen"],
                 self.prefill.slot_leader(r["slot"])) for r in recs],
                **self._tier_facts(self.prefill, "pf")}
            # rows harvested here are in flight, no longer resident
            facts["pf_active"] -= len(recs)
        else:
            spliced = self._splice_arrivals()
            more = bool(self.queue or self._in_transit
                        or self._facts.get("pf_active", 0))
            cap = max_steps if max_steps is not None else (
                self.segment_steps if more else None)
            finished = self.decode.step(
                expect_arrivals=more or expect_arrivals, max_steps=cap)
            facts = {"spliced": spliced, "victims": self._victims,
                     "finished": finished,
                     "de_resident": self.decode.resident(),
                     **self._tier_facts(self.decode, "de")}
            self._victims = []
        leaders = self._exchange(
            facts if self._is_leader() else None)
        pf = next(f for f in leaders if f and "recs" in f)
        de = next(f for f in leaders if f and "spliced" in f)
        self._facts = {k: v for f in (pf, de) for k, v in f.items()
                       if k.startswith(("pf_", "de_"))}
        # apply the round alike on every rank, in the single-process order
        self._pending_feed += self.queue[:pf["n_admitted"]]
        del self.queue[:pf["n_admitted"]]
        if self.decode is None:
            self._in_transit = [t for t in self._in_transit
                                if t.req.request_id not in de["spliced"]]
        self._requeue_victims(de["victims"])
        byid = {q.request_id: q for q in self._pending_feed}
        for slot, rid, t0, plen, owner in pf["recs"]:
            q, k, v = byid[rid], None, None
            if self.prefill is not None and owner == self._my_rank():
                k, v = self.prefill.export_slot(slot, self.ship_cols)
            got = self._wire(owner, k, v)
            if got is not None:
                k, v = got
            self.transfers += 1
            self.transfer_bytes += 2 * int(np.prod(self._wire_shape())) \
                * self.cfg.dtype("compute").itemsize
            self._in_transit.append(_Shipment(q, t0, plen, k, v,
                                              self._round))
        if self.prefill is not None and pf["recs"]:
            self.prefill.release_slots([r[0] for r in pf["recs"]])
        self._pending_feed = [q for q in self._pending_feed
                              if q.request_id not in
                              {r[1] for r in pf["recs"]}]
        finished = de["finished"]
        self._close_round(finished)
        return finished

    def _wire_shape(self):
        """A shipment's buffer shape, ``export_rows``' for one row."""
        cfg = self.cfg
        return (engine._attn_layer_count(cfg), 1, self.ship_cols,
                self._kv_block, cfg.n_kv_heads, cfg.resolved_head_dim)

    def _is_leader(self) -> bool:
        me = self._my_rank()
        return me in (self._pf_ranks[0], self._de_ranks[0])

    @staticmethod
    def _my_rank() -> int:
        import torch.distributed as dist
        return dist.get_rank()

    @staticmethod
    def _tier_facts(tier, tag: str) -> dict:
        """What the other slice reads of a tier: counts for ``pending``
        and the report, and the paths that ran."""
        return {f"{tag}_active": tier.active_count,
                f"{tag}_pending": tier.pending,
                f"{tag}_steps": tier.total_steps,
                f"{tag}_segments": tier.segments,
                f"{tag}_host_reads": tier.host_reads,
                f"{tag}_tokens": tier.tokens_emitted,
                f"{tag}_peak": tier.peak_resident,
                f"{tag}_attn_impl": tier.attn_impl,
                f"{tag}_prefill_impl": tier.prefill_impl,
                f"{tag}_loop_impl": tier.loop_impl,
                f"{tag}_layout": tier.pool_layout,
                f"{tag}_gathers": kvc.PagedView.gather_calls}

    # ---------------- shipping ----------------------------------------

    def _ship(self, rec) -> None:
        """Export one harvested prefill row into a fresh wire buffer and
        queue the shipment (module docstring: the side stream and its
        event)."""
        q = dataclasses.replace(
            rec["req"], max_new=self._orig_max_new[rec["req"].request_id])
        node = self.prefill.pool.cache[self.prefill._kv_key]

        def export():
            rows = torch.full((1,), rec["slot"], dtype=torch.int64,
                              device=self.device)        # a fill: no copy
            return node.export_rows(rows, self.ship_cols)

        ready = timing = None
        if self._side is None:
            k, v = export()
        else:
            self._side.wait_stream(self.prefill._stream)
            with torch.cuda.stream(self._side):
                timing = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                timing[0].record()
                k, v = export()
                timing[1].record()
                ready = torch.cuda.Event()
                ready.record()
            # the prefill tier recycles these blocks only after the copy
            self.prefill._stream.wait_event(ready)
            self._export_events.append(timing)
        self.transfers += 1
        self.transfer_bytes += k.numel() * k.element_size() \
            + v.numel() * v.element_size()
        self._in_transit.append(_Shipment(q, rec["t0"], rec["plen"], k, v,
                                          self._round, ready, timing))

    # ---------------- decode-tier admission ---------------------------

    def _splice_arrivals(self) -> int:
        """Splice in-transit shipments, most urgent first, into free
        decode slots, preempting lower-priority residents when the head
        shipment does not fit. A shipment dispatched in this round
        stays in flight: it splices in a later one. Returns the spliced
        request ids."""
        spliced: List[int] = []
        while self._in_transit:
            i = min(range(len(self._in_transit)),
                    key=lambda j: (self._in_transit[j].req.priority,
                                   self._in_transit[j].req.deadline,
                                   self._in_transit[j].req.request_id))
            t = self._in_transit[i]
            if t.round >= self._round:
                break
            need = self.decode.blocks_for(t.plen, t.req.max_new)
            if not self.decode.fits(need):
                if not self._maybe_preempt(t.req.priority, need):
                    break
            if self._side is not None:
                for buf in (t.k, t.v):   # kept until the import has run
                    buf.record_stream(self.decode._stream)
            self.decode.splice_requests([t.req], [t.t0], [t.plen], t.k, t.v,
                                        ready=t.ready)
            del self._in_transit[i]
            spliced.append(t.req.request_id)
        return spliced

    def _maybe_preempt(self, priority: int, need: int) -> bool:
        """The SLO layer's eviction plan on the decode tier: evict
        strictly lower-priority residents (the least urgent class first,
        then the most reclaimable blocks, then the least replay work),
        committing only if that admits the head shipment. Victims
        re-enter the backlog to recompute through the prefill tier, and
        their snapshots are held against the replayed streams. The
        order reads the decode tier's host mirrors: no read."""
        dec = self.decode
        victims = [s for s in range(dec.n_slots)
                   if dec._busy[s] and dec._slot_req[s] is not None
                   and dec._slot_req[s].priority > priority]
        if not victims:
            return False
        reclaim = dec.reclaimable_host()
        n_emitted = dec._h_n_emitted
        victims.sort(key=lambda s: (-dec._slot_req[s].priority,
                                    -int(reclaim[s]), int(n_emitted[s]), s))
        plan: List[int] = []
        for s in victims:
            if dec.fits(need, plan):
                break
            plan.append(s)
        if not dec.fits(need, plan):
            return False
        self._victims += [(p.request_id, p.tokens, sched_lib._Queued(
            p.request_id, p.prompt, p.max_new, p.key, p.priority,
            p.deadline, p.prefix_embeds)) for p in dec.preempt_slots(plan)]
        return True

    def _requeue_victims(self, victims) -> None:
        """Victims re-enter the backlog, their snapshots kept for the
        replay check (after the round's splices, before the next sort)."""
        for rid, tokens, q in victims:
            self._snapshots[rid] = tokens
            self.queue.append(q)
        self.preemptions += len(victims)

    # ---------------- submission --------------------------------------

    def submit(self, prompt, *, max_new: int,
               request_id: Optional[int] = None, key=None,
               priority: int = 0, deadline: float = float("inf"),
               prefix_embeds=None) -> int:
        """Queue one request into the backlog. The prefill tier's
        ``submit`` validates the prompt (and a VLM's ``prefix_embeds``);
        the router assigns the id and checks what the decode tier needs,
        alike on every rank of a fleet (a decode rank holds no prefill
        tier, and checks the prompt's shape itself)."""
        if not 1 <= max_new <= self.max_new_cap:
            raise ValueError(f"max_new must be in [1, {self.max_new_cap}]")
        prompt = np.asarray(prompt)
        if prompt.ndim != 2 or prompt.shape[0] != 1 or \
                not 1 <= prompt.shape[1] <= self.prompt_len:
            raise ValueError(f"prompt must be (1, L) with 1 <= L <= "
                             f"{self.prompt_len}; got {prompt.shape}")
        if self.cfg.family not in ("dense", "vlm") and \
                prompt.shape[1] != self.prompt_len:
            raise ValueError(f"family {self.cfg.family!r} requires "
                             f"exact-length prompts (1, {self.prompt_len})")
        need = int(kvc.blocks_needed(prompt.shape[1] + self.prefix_len
                                     + max_new + 1, self._kv_block))
        if need > self._decode_kv_blocks:
            raise ValueError(
                f"request needs {need} decode-tier blocks but the pool "
                f"has kv_blocks={self._decode_kv_blocks}")
        if self.pending == 0:
            self.reset_stats()
        rid = self._next_rid if request_id is None else int(request_id)
        self._next_rid = max(self._next_rid, rid) + 1
        if self.prefill is not None:
            self.prefill.submit(prompt, max_new=1, request_id=rid, key=key,
                                priority=priority, deadline=deadline,
                                prefix_embeds=prefix_embeds)
            q = self.prefill.queue.pop()
        else:
            if self.prefix_len and (prefix_embeds is None or np.shape(
                    prefix_embeds)[:2] != (1, self.prefix_len)):
                raise ValueError(f"every request needs prefix_embeds (1, "
                                 f"{self.prefix_len}, d)")
            if key is not None:
                key = np.asarray(key, np.int64).reshape(2) & 0xFFFFFFFF
            q = sched_lib._Queued(
                rid, prompt.astype(np.int32), 1, key, int(priority),
                float(deadline), None if prefix_embeds is None
                else np.asarray(prefix_embeds))
        self.queue.append(dataclasses.replace(q, max_new=int(max_new)))
        self._orig_max_new[rid] = int(max_new)
        return rid

    @property
    def pending(self) -> int:
        """Requests not finished: backlogged, prefilling, in flight
        between the tiers, or decoding (on a fleet, the tiers' counts as
        the last round's exchange gave them)."""
        if self._meshed:
            return (len(self.queue) + self._facts.get("pf_active", 0)
                    + len(self._in_transit)
                    + self._facts.get("de_pending", 0))
        return (len(self.queue) + self.prefill.active_count
                + len(self._in_transit) + self.decode.pending)

    # ---------------- a round -----------------------------------------

    def step(self, expect_arrivals: bool = False,
             max_steps: Optional[int] = None
             ) -> List[sched_lib.FinishedRequest]:
        """One round:

        1. unless the prefill tier's last segment is unharvested: sort
           the backlog, feed the prefill tier and launch its segment
           without waiting (``dispatch_segment``);
        2. splice earlier rounds' shipments into decode slots
           (preempting for an urgent head);
        3. run one decode segment, capped at ``segment_steps`` while the
           pipeline feeds it (``max_steps`` overrides);
        4. harvest the prefill tier, polling its segment while the decode
           tier still has work, waiting for it otherwise; export and
           queue each finished row, then release the rows;
        5. hold replayed streams to their preemption snapshots.

        On a fleet (``prefill_mesh``/``decode_mesh``) the round is
        ``_step_mesh``: the same order, each tier on its own slice, the
        prefill harvest waited for.

        Returns the requests that finished decoding this round."""
        if self._meshed:
            return self._step_mesh(expect_arrivals, max_steps)
        self._round += 1
        if not self._prefill_inflight:
            self.queue.sort(key=lambda q: (q.priority, q.deadline,
                                           q.request_id))
            feed = [dataclasses.replace(q, max_new=1) for q in self.queue]
            self.prefill.queue.extend(feed)
            launched = self.prefill.dispatch_segment(
                expect_arrivals=True, max_steps=self.prefill_segment_steps)
            n_admitted = len(feed) - len(self.prefill.queue)
            self.prefill.queue.clear()
            del self.queue[:n_admitted]
            self._prefill_inflight = launched
        self._splice_arrivals()
        self._requeue_victims(self._victims)
        self._victims = []
        more = bool(self.queue or self._in_transit
                    or self.prefill.active_count)
        cap = max_steps if max_steps is not None else (
            self.segment_steps if more else None)
        finished = self.decode.step(expect_arrivals=more or expect_arrivals,
                                    max_steps=cap)
        recs = []
        if self._prefill_inflight:
            decode_busy = self.decode.active_count > 0 or \
                bool(self._in_transit)
            if not decode_busy or self.prefill.segment_done():
                recs = self.prefill.harvest_prefilled()
                self._prefill_inflight = False
        for rec in recs:
            self._ship(rec)
        if recs:
            self.prefill.release_slots([r["slot"] for r in recs])
        self._close_round(finished)
        return finished

    def _close_round(self, finished) -> None:
        """Hold replayed streams to their preemption snapshots; count the
        finished."""
        for f in finished:
            snap = self._snapshots.pop(f.request_id, None)
            if snap is not None and len(snap):
                m = min(len(snap), len(f.tokens))
                if not np.array_equal(np.asarray(f.tokens[:m]), snap[:m]):
                    self.replay_mismatches += 1
            self._orig_max_new.pop(f.request_id, None)
            self.completed += 1

    def run_until_drained(self) -> List[sched_lib.FinishedRequest]:
        """Drive rounds until the whole pipeline is empty."""
        results: List[sched_lib.FinishedRequest] = []
        while self.pending:
            before = self._progress()
            results.extend(self.step())
            if self._progress() == before:
                raise RuntimeError("disaggregated scheduler made no "
                                   "progress")
        return results

    def _progress(self):
        return (self.pending, self.total_steps, self.prefill_steps,
                self.transfers, self._round if self._meshed else 0,
                self._tier("prefill", "segments", "pf_segments"),
                self._tier("decode", "segments", "de_segments"))

    def _tier(self, tier: str, attr: str, fact: str):
        """A tier's ``attr`` where this rank holds the tier, else what the
        last exchange said of it."""
        t = getattr(self, tier)
        return getattr(t, attr) if t is not None else self._facts.get(
            fact, 0)

    def _tiers(self):
        return [t for t in (self.prefill, self.decode) if t is not None]

    def warmup(self) -> None:
        """Capture the tiers' segments before serving (on a fleet, the
        tier this rank holds)."""
        for t in self._tiers():
            t.warmup()

    def close(self) -> None:
        """Free the tiers' captured segments."""
        for t in self._tiers():
            t.close()

    # ---------------- counters ----------------------------------------

    def reset_stats(self) -> None:
        for t in self._tiers():
            t.reset_stats()
        self.transfers = 0
        self.transfer_bytes = 0
        self.preemptions = 0
        self.replay_mismatches = 0
        self.completed = 0
        self._export_events = []
        self.transfer_ms = []
        # the other slice's counters restart with this rank's
        for k in list(self._facts):
            if not k.endswith(("_impl", "_layout")):
                self._facts[k] = 0

    @property
    def export_ms(self) -> float:
        """Device milliseconds of the exports since the run began (CUDA
        events around each on the side stream; waits for the last). 0.0
        on the CPU and on a fleet (whose shipments ``transfer_ms``
        times)."""
        total = 0.0
        for start, end in self._export_events:
            end.synchronize()
            total += start.elapsed_time(end)
        return total

    @property
    def transfer_impl(self) -> str:
        """How prefilled K/V reaches the decode kernel: in one process a
        device copy on a side stream of the one card
        (``torch-copy:cpu`` on the CPU, where it runs in the call); on a
        fleet a broadcast from the prefill rank that holds the row to the
        decode slice, staged through host memory under gloo
        (``bcast:gloo-host``), from the device under NCCL
        (``bcast:nccl``)."""
        if self._meshed:
            return ("bcast:gloo-host" if self._backend == "gloo"
                    else f"bcast:{self._backend}")
        return ("cuda-copy:side-stream" if self._side is not None
                else "torch-copy:cpu")

    @property
    def attn_impl(self) -> str:
        return self._tier("decode", "attn_impl", "de_attn_impl")

    @property
    def prefill_impl(self) -> str:
        return self._tier("prefill", "prefill_impl", "pf_prefill_impl")

    @property
    def loop_impl(self) -> str:
        return self._tier("decode", "loop_impl", "de_loop_impl")

    @property
    def total_steps(self) -> int:
        """Decode-tier loop iterations (the delivery clock; the prefill
        tier's are ``prefill_steps``)."""
        return self._tier("decode", "total_steps", "de_steps")

    @property
    def prefill_steps(self) -> int:
        return self._tier("prefill", "total_steps", "pf_steps")

    @property
    def tokens_emitted(self) -> int:
        return self._tier("decode", "tokens_emitted", "de_tokens")

    @property
    def peak_resident(self) -> int:
        return self._tier("decode", "peak_resident", "de_peak")

    def resident(self) -> Dict[int, np.ndarray]:
        """The decode tier's resident requests and their emissions, as
        of its last harvest (what has reached the host; on a rank that
        holds no decode tier, as the last exchange gave them)."""
        if self.decode is not None:
            return self.decode.resident()
        return dict(self._facts.get("de_resident") or {})
