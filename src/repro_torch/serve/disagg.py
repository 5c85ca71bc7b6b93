"""Prefill/decode disaggregation on one card: a two-tier router over a
prefill scheduler and a decode scheduler, with the finished prompts' KV
blocks shipped between their pools.

Port of ``repro/serve/disagg.py``. The JAX package puts the two tiers on
disjoint submeshes of a device fleet and ships blocks with an async
``jax.device_put``; this port runs on one card, so both tiers share its
memory and its SMs, and a shipment is a device copy:

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
only double their memory. ``prefill_mesh``/``decode_mesh`` other than
None are tiers on submeshes, slice 7c of ROADMAP.md, and refused.

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

from . import kv_cache as kvc
from . import sampling as sampling_lib
from . import scheduler as sched_lib

__all__ = ["DisaggScheduler"]

_MULTI_DEVICE = ("the tiers on submeshes are slice 7c of the port "
                 "(ROADMAP.md queue 1 item 7); on one card both tiers "
                 "share it: pass prefill_mesh=None and decode_mesh=None")


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
    """Two-tier router over a prefill tier and a decode tier on one card.

    Args:
      params, cfg: the model; both tiers read these parameters.
      n_prefill_slots / n_decode_slots: each tier's slots. The prefill
        tier turns a slot over once a prompt, so it runs much smaller.
      prompt_len, max_new_cap, eos_id, sampling, seed: as the colocated
        scheduler's; ``seed`` is shared by the tiers (both derive request
        keys from it).
      prefill_mesh / decode_mesh: refused unless None (submeshes, slice
        7c).
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
        if prefill_mesh is not None or decode_mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
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
        self.segment_steps = int(segment_steps)
        self.prefill_segment_steps = int(prefill_segment_steps
                                         or segment_steps)
        # max_new_cap=1 sizes the prefill pool to prompts; prefill_only
        # retires rows instead of decoding them. The prefill tier works
        # on a stream of its own (the scheduler keeps the stream current
        # when it is built), so that its segments may overlap the
        # decode tier's on the card.
        dev = params["embed"].device
        pf_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                     else None)
        with (torch.cuda.stream(pf_stream) if pf_stream is not None
              else contextlib.nullcontext()):
            self.prefill = sched_lib.DecodeScheduler(
                params, cfg, n_slots=n_prefill_slots, prompt_len=prompt_len,
                max_new_cap=1, eos_id=eos_id, sampling=sampling, seed=seed,
                kv="paged", kv_block=kv_block, kv_blocks=prefill_kv_blocks,
                prefill="chunked", chunk_tokens=chunk_tokens,
                prefix_cache=prefix_cache, prefill_only=True,
                prefix_len=self.prefix_len)
        self.decode = sched_lib.DecodeScheduler(
            params, cfg, n_slots=n_decode_slots,
            prompt_len=prompt_len + self.prefix_len,
            max_new_cap=max_new_cap, eos_id=eos_id, sampling=sampling,
            seed=seed, kv="paged", kv_block=kv_block,
            kv_blocks=decode_kv_blocks, prefill="chunked",
            chunk_tokens=chunk_tokens, speculative=speculative)
        self.device = self.decode.device
        # one wire shape for every prompt: columns for the longest
        self.ship_cols = int(kvc.blocks_needed(prompt_len + self.prefix_len,
                                               kv_block))
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        # router state
        self.queue: List[sched_lib._Queued] = []   # the priority backlog
        self._in_transit: List[_Shipment] = []
        self._orig_max_new: Dict[int, int] = {}
        self._snapshots: Dict[int, np.ndarray] = {}
        self._round = 0
        self._prefill_inflight = False   # a launched, unharvested segment
        self._export_events: List[tuple] = []
        self.reset_stats()

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
        stays in flight: it splices in a later one."""
        spliced = 0
        while self._in_transit:
            i = min(range(len(self._in_transit)),
                    key=lambda j: (self._in_transit[j].req.priority,
                                   self._in_transit[j].req.deadline,
                                   self._in_transit[j].req.request_id))
            t = self._in_transit[i]
            if t.round >= self._round:
                break
            need = self.decode.blocks_for(t.plen, t.req.max_new)
            if self.decode.free_slots < 1 or self.decode.free_blocks < need:
                if not self._maybe_preempt(t.req.priority, need):
                    break
            if self._side is not None:
                for buf in (t.k, t.v):   # kept until the import has run
                    buf.record_stream(self.decode._stream)
            self.decode.splice_requests([t.req], [t.t0], [t.plen], t.k, t.v,
                                        ready=t.ready)
            del self._in_transit[i]
            spliced += 1
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
        slots_free, blocks_free = dec.free_slots, dec.free_blocks
        for s in victims:
            if slots_free >= 1 and blocks_free >= need:
                break
            plan.append(s)
            slots_free += 1
            blocks_free = dec.free_blocks + dec.blocks_freed(plan)
        if slots_free < 1 or blocks_free < need:
            return False
        for p in dec.preempt_slots(plan):
            self._snapshots[p.request_id] = p.tokens
            self.queue.append(sched_lib._Queued(
                p.request_id, p.prompt, p.max_new, p.key, p.priority,
                p.deadline, p.prefix_embeds))
        self.preemptions += len(plan)
        return True

    # ---------------- submission --------------------------------------

    def submit(self, prompt, *, max_new: int,
               request_id: Optional[int] = None, key=None,
               priority: int = 0, deadline: float = float("inf"),
               prefix_embeds=None) -> int:
        """Queue one request into the backlog. The prefill tier's
        ``submit`` validates the prompt (and a VLM's ``prefix_embeds``)
        and assigns the id; the decode-tier residency check is the
        router's."""
        if not 1 <= max_new <= self.decode.max_new_cap:
            raise ValueError(
                f"max_new must be in [1, {self.decode.max_new_cap}]")
        prompt = np.asarray(prompt)
        if prompt.ndim == 2:
            need = self.decode.blocks_for(prompt.shape[1] + self.prefix_len,
                                          max_new)
            if need > self.decode.kv_blocks:
                raise ValueError(
                    f"request needs {need} decode-tier blocks but the "
                    f"pool has kv_blocks={self.decode.kv_blocks}")
        if self.pending == 0:
            self.reset_stats()
        rid = self.prefill.submit(prompt, max_new=1, request_id=request_id,
                                  key=key, priority=priority,
                                  deadline=deadline,
                                  prefix_embeds=prefix_embeds)
        q = self.prefill.queue.pop()
        self.queue.append(dataclasses.replace(q, max_new=int(max_new)))
        self._orig_max_new[rid] = int(max_new)
        return rid

    @property
    def pending(self) -> int:
        """Requests not finished: backlogged, prefilling, in flight
        between the tiers, or decoding."""
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

        Returns the requests that finished decoding this round."""
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
        for f in finished:
            snap = self._snapshots.pop(f.request_id, None)
            if snap is not None and len(snap):
                m = min(len(snap), len(f.tokens))
                if not np.array_equal(np.asarray(f.tokens[:m]), snap[:m]):
                    self.replay_mismatches += 1
            self._orig_max_new.pop(f.request_id, None)
            self.completed += 1
        return finished

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
        return (self.pending, self.decode.total_steps,
                self.prefill.total_steps, self.transfers,
                self.prefill.segments, self.decode.segments)

    def warmup(self) -> None:
        """Capture both tiers' segments before serving."""
        self.prefill.warmup()
        self.decode.warmup()

    def close(self) -> None:
        """Free both tiers' captured segments."""
        self.prefill.close()
        self.decode.close()

    # ---------------- counters ----------------------------------------

    def reset_stats(self) -> None:
        self.prefill.reset_stats()
        self.decode.reset_stats()
        self.transfers = 0
        self.transfer_bytes = 0
        self.preemptions = 0
        self.replay_mismatches = 0
        self.completed = 0
        self._export_events = []

    @property
    def export_ms(self) -> float:
        """Device milliseconds of the exports since the run began (CUDA
        events around each on the side stream; waits for the last). 0.0
        on the CPU."""
        total = 0.0
        for start, end in self._export_events:
            end.synchronize()
            total += start.elapsed_time(end)
        return total

    @property
    def transfer_impl(self) -> str:
        """How prefilled K/V reaches the decode kernel: a device copy on
        a side stream of the one card (``torch-copy:cpu`` on the CPU,
        where it runs in the call)."""
        return ("cuda-copy:side-stream" if self._side is not None
                else "torch-copy:cpu")

    @property
    def attn_impl(self) -> str:
        return self.decode.attn_impl

    @property
    def prefill_impl(self) -> str:
        return self.prefill.prefill_impl

    @property
    def loop_impl(self) -> str:
        return self.decode.loop_impl

    @property
    def total_steps(self) -> int:
        """Decode-tier loop iterations (the delivery clock; the prefill
        tier's are ``prefill_steps``)."""
        return self.decode.total_steps

    @property
    def prefill_steps(self) -> int:
        return self.prefill.total_steps

    @property
    def tokens_emitted(self) -> int:
        return self.decode.tokens_emitted

    @property
    def peak_resident(self) -> int:
        return self.decode.peak_resident

    def resident(self) -> Dict[int, np.ndarray]:
        """The decode tier's resident requests and their emissions, as
        of its last harvest (what has reached the host)."""
        return self.decode.resident()
