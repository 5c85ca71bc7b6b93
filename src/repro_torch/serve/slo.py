"""SLO-aware serving layer: priority scheduling + block-level preemption.

Port of ``repro/serve/slo.py``. Every decision reads host mirrors that
the inner scheduler's harvest brought in its one read a segment
(``emitted``, ``reclaimable_host``, ``_busy``): a round makes one host
read, the harvest's.

The paper's argument, applied one level up from the decode loop:
scheduling decisions that depend on data — *this* request is urgent,
*that* resident slot is expendable, the block pool just ran dry —
belong in the runtime, close to the state they read. The base
:class:`~repro_torch.serve.scheduler.DecodeScheduler` is a FIFO driver with
head-of-line block gating; under overload every request waits the same
queue, so an interactive request behind a batch scrape eats the whole
backlog's latency. This module layers policy over that engine — a
LIBRARY over the scheduler, not a fork of it (the TF-system papers'
framing): the inner scheduler keeps owning slots, blocks, and the
in-graph step; the SLO layer owns *ordering* and *eviction*.

Three mechanisms:

1. **Priority + deadline ordering.** Requests carry a priority class
   (lower = more urgent) and a deadline; the backlog is re-sorted by
   ``(priority, deadline, arrival)`` every round and fed to the inner
   scheduler's FIFO queue in that order. The inner head-of-line block
   gate then *is* strict priority admission: nothing overtakes a more
   urgent request that is still waiting for blocks.

2. **Block-level preemption.** When the most urgent waiting request
   cannot be admitted (no free slot, or the paged free-list is short)
   and strictly-lower-priority requests are resident, the layer evicts
   victims: ``DecodeScheduler.preempt_slots`` frees their blocks
   through the refcounted ``free`` in one device dispatch, snapshots
   their emitted tokens host-side, and the requests re-enter the
   backlog for **recompute-from-prompt**. Nothing is swapped out:
   with prefix caching the replayed prompt usually maps straight back
   onto still-pinned blocks, and the identical request key + emission-index PRNG
   keying make the replayed stream bit-identical to the uninterrupted
   one, so a streaming front-end just skips the first
   ``delivered`` tokens. Victim choice is (priority desc, reclaimable
   blocks desc, emitted tokens asc) — evict the most expendable row
   that actually returns blocks (``KVCache.reclaimable``) and has the
   least work to replay.

3. **Bounded device segments.** Each round caps the in-graph segment
   at ``segment_steps`` iterations (``DecodeScheduler.step(max_steps=)``),
   so tokens surface and preemption decisions are re-made every few
   steps even when no slot frees — the latency a streaming front-end
   observes is the segment length, not the drain tail.

Metrics are recorded in **both** clocks: loop *steps* (device-loop
facts — deterministic, what CI gates assert) and *wall* seconds (what
an operator sees). TTFT = submission → first token; ITL = amortized
inter-token gap (a burst of ``j`` tokens over a gap ``g`` records
``j`` samples of ``g/j`` — speculative windows emit bursts, and the
amortized form is the per-token latency a reader of the stream
experiences). ``json_summary`` reports per-class p50/p99 of each.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import scheduler as sched_lib


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A priority class with latency targets.

    priority: lower = more urgent (0 is the most urgent class).
    ttft_budget / itl_budget: wall-second targets used for deadline
    derivation (deadline = arrival + ttft_budget) and for the
    attainment fractions in ``json_summary`` — the layer never drops
    a request for missing them (clients time out, servers don't).
    """

    name: str
    priority: int = 0
    ttft_budget: Optional[float] = None
    itl_budget: Optional[float] = None


#: Reasonable defaults: interactive traffic preempts batch traffic.
INTERACTIVE = SLOClass("interactive", priority=0, ttft_budget=1.0,
                       itl_budget=0.2)
BATCH = SLOClass("batch", priority=2)


@dataclasses.dataclass
class Event:
    """One observable request-lifecycle transition, returned by
    ``step()`` in occurrence order. ``kind``:

    - ``"token"``: ``tokens`` holds the NEWLY delivered ids (never a
      re-delivery — replayed prefixes after preemption are skipped).
    - ``"finished"``: request completed; ``tokens`` holds any final
      undelivered ids (often empty) and ``finished`` the inner
      :class:`FinishedRequest`.
    - ``"preempted"``: request was evicted and re-queued; ``tokens``
      is empty (nothing new was delivered — and nothing already
      delivered is ever revoked).
    """

    kind: str
    request_id: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: Any = None


@dataclasses.dataclass
class _ReqState:
    """Host record of one in-flight request (keyed by rid)."""

    cls: SLOClass
    arrival_wall: float
    arrival_step: int
    delivered: int = 0            # tokens already surfaced to events
    first_token_step: Optional[int] = None
    first_token_wall: Optional[float] = None
    last_emit_step: int = 0
    last_emit_wall: float = 0.0
    snapshot: Optional[np.ndarray] = None   # emitted at last preemption
    n_preempts: int = 0


class SLOScheduler:
    """Priority/deadline backlog + preemption planner over a
    :class:`DecodeScheduler`.

    Construct the inner scheduler first (any configuration — paged or
    dense, chunked or one-shot, speculative or not) and hand it over;
    the SLO layer never touches model state, only the inner host API
    (``submit``/``step``/``preempt_slots``/host mirrors).

    Thread safety: ``submit`` and ``step`` serialize on one lock, so
    an asyncio front-end may submit from the event loop while ``step``
    runs in a worker thread (``serve.frontend``).

    Args:
      inner: the engine. Its queue must be empty (the SLO layer owns
        ordering; a pre-filled FIFO would bypass it).
      segment_steps: in-graph iteration cap per round — the token
        surfacing / preemption-revisit granularity.
      classes: optional name → :class:`SLOClass` registry for
        ``submit(slo_class="interactive")`` string lookups.
    """

    def __init__(self, inner: sched_lib.DecodeScheduler, *,
                 segment_steps: int = 8,
                 classes: Optional[Dict[str, SLOClass]] = None):
        if inner.queue:
            raise ValueError("inner scheduler queue must be empty: the "
                             "SLO layer owns request ordering")
        if segment_steps < 1:
            raise ValueError("segment_steps must be >= 1")
        self.inner = inner
        self.segment_steps = int(segment_steps)
        self.classes = dict(classes) if classes else {
            c.name: c for c in (INTERACTIVE, BATCH)}
        self._lock = threading.Lock()
        self._backlog: List[sched_lib._Queued] = []
        self._req: Dict[int, _ReqState] = {}
        # step clock: survives the inner scheduler's per-run stats
        # reset (submit-on-idle zeroes inner.total_steps)
        self._clock = 0
        self._prev_inner_steps = 0
        self._metrics: Dict[str, dict] = {}
        # counters
        self.preemptions = 0
        self.replay_mismatches = 0    # MUST stay 0: bit-identity broken
        self.completed = 0
        self.rounds = 0               # step() calls
        self.host_reads = 0           # the inner scheduler's, in step()

    # ---------------- submission --------------------------------------

    def submit(self, prompt, *, max_new: int, slo_class="batch",
               deadline: Optional[float] = None, request_id=None,
               key=None, prefix_embeds=None, frames=None) -> int:
        """Queue one request under a priority class.

        slo_class: an :class:`SLOClass` or a registered class name.
        deadline: absolute ``time.monotonic()`` seconds; defaults to
        arrival + the class's ``ttft_budget`` (``+inf`` without one).
        Deadlines ORDER requests within a class — they never drop one.
        ``prefix_embeds``: a VLM request's patch embeddings, and
        ``frames``: an audio request's frame embeddings, kept with the
        request, so that a preempted one replays with them.
        """
        cls = (self.classes[slo_class] if isinstance(slo_class, str)
               else slo_class)
        now = time.monotonic()
        if deadline is None:
            deadline = (now + cls.ttft_budget
                        if cls.ttft_budget is not None else float("inf"))
        with self._lock:
            # a submit onto a fully drained inner scheduler resets its
            # per-run stats (scheduler.reset_stats); re-anchor the
            # layer's step clock so _advance_clock's delta stays exact
            if not self.inner.queue and not self.inner._busy.any():
                self._prev_inner_steps = 0
            # validation + rid assignment live in the inner submit;
            # the queued record is immediately pulled into the backlog
            # (the inner FIFO admits only what the SLO layer feeds it)
            rid = self.inner.submit(
                prompt, max_new=max_new, request_id=request_id, key=key,
                priority=cls.priority, deadline=float(deadline),
                prefix_embeds=prefix_embeds, frames=frames)
            q = self.inner.queue.pop()
            self._backlog.append(q)
            self._req[rid] = _ReqState(
                cls=cls, arrival_wall=now, arrival_step=self._clock,
                last_emit_wall=now, last_emit_step=self._clock)
            # per-class sample stores are created lazily
            self._metrics_for(cls.name)
        return rid

    @property
    def pending(self) -> int:
        """Requests not yet finished (backlog + resident)."""
        with self._lock:
            return len(self._backlog) + int(self.inner._busy.sum())

    # ---------------- scheduling round --------------------------------

    def step(self) -> List[Event]:
        """One SLO round: sort → preempt if needed → admit → bounded
        device segment → observe tokens/finishes. Returns the round's
        events in occurrence order ("preempted" first: those tokens
        were withheld, not delivered)."""
        with self._lock:
            self.rounds += 1
            reads0 = self.inner.host_reads
            events: List[Event] = []
            self._backlog.sort(key=lambda q: (q.priority, q.deadline,
                                              q.request_id))
            events.extend(self._maybe_preempt())
            self.inner.queue.extend(self._backlog)
            self._backlog.clear()
            finished = self.inner.step(
                expect_arrivals=bool(self.inner.queue),
                max_steps=self.segment_steps)
            # the inner FIFO is drained back every round so NEW
            # arrivals re-sort against what it couldn't admit
            self._backlog.extend(self.inner.queue)
            self.inner.queue.clear()
            self._advance_clock()
            events.extend(self._observe(finished))
            self.host_reads += self.inner.host_reads - reads0
        return events

    def run_until_drained(self) -> List[Event]:
        """Drive until nothing is backlogged or resident."""
        events: List[Event] = []
        while self.pending:
            before = self.pending
            got = self.step()
            events.extend(got)
            if self.pending == before and not got:
                raise RuntimeError("SLO scheduler made no progress")
        return events

    def _advance_clock(self) -> None:
        """Fold the inner segment's iterations into the layer's own
        monotonic step clock (immune to the inner per-run reset)."""
        cur = self.inner.total_steps
        delta = cur - self._prev_inner_steps
        if delta < 0:              # inner stats were reset mid-flight
            delta = cur
        self._clock += delta
        self._prev_inner_steps = cur

    # ---------------- preemption planning -----------------------------

    def _maybe_preempt(self) -> List[Event]:
        """Evict strictly-lower-priority residents when the most urgent
        backlogged request cannot be admitted. The plan is computed
        against host mirrors (free slots / free blocks /
        per-slot holdings) and committed only if it actually makes the
        head admissible — no partial evictions for nothing."""
        inner = self.inner
        if not self._backlog:
            return []
        head = self._backlog[0]
        need = inner.blocks_for(head.prompt.shape[1], head.max_new)
        if inner.fits(need):
            return []               # admissible as-is
        # eligible victims: resident, strictly less urgent than head
        victims = [s for s in range(inner.n_slots)
                   if inner._busy[s] and inner._slot_req[s] is not None
                   and inner._slot_req[s].priority > head.priority]
        if not victims:
            return []
        # order: most expendable class first, then rows whose eviction
        # returns the most blocks (KVCache.reclaimable — shared/pinned
        # blocks return nothing), then least work to replay; both from
        # the last harvest's read
        reclaim = inner.reclaimable_host()
        victims.sort(key=lambda s: (-inner._slot_req[s].priority,
                                    -int(reclaim[s]),
                                    len(inner.emitted(s)), s))
        plan: List[int] = []
        for s in victims:
            if inner.fits(need, plan):
                break
            plan.append(s)
        if not inner.fits(need, plan):
            return []               # infeasible: evicting buys nothing
        events = []
        for p in inner.preempt_slots(plan):
            st = self._req[p.request_id]
            st.snapshot = p.tokens
            st.n_preempts += 1
            # replay regenerates from step 0: TTFT/ITL keep accruing
            # against the ORIGINAL arrival — the victim pays its wait
            # in the metrics, which is exactly what bench_slo measures
            self._backlog.append(sched_lib._Queued(
                p.request_id, p.prompt, p.max_new, p.key, p.priority,
                p.deadline, p.prefix_embeds, p.frames))
            events.append(Event("preempted", p.request_id))
        self.preemptions += len(plan)
        self._backlog.sort(key=lambda q: (q.priority, q.deadline,
                                          q.request_id))
        return events

    # ---------------- token observation -------------------------------

    def _deliver(self, rid: int, stream: np.ndarray) -> List[int]:
        """Advance a request's delivered cursor along its regenerated
        stream, verifying a replayed prefix against the preemption
        snapshot (bit-identity is a hard guarantee: greedy decode and
        emission-index PRNG keying make the replay deterministic)."""
        st = self._req[rid]
        n = len(stream)
        if st.snapshot is not None and n:
            m = min(n, len(st.snapshot))
            if not np.array_equal(stream[:m], st.snapshot[:m]):
                self.replay_mismatches += 1
        if n <= st.delivered:
            return []
        fresh = stream[st.delivered:n]
        now = time.monotonic()
        mx = self._metrics_for(st.cls.name)
        if st.first_token_step is None:
            mx["ttft_steps"].append(self._clock - st.arrival_step)
            mx["ttft_wall"].append(now - st.arrival_wall)
            st.first_token_step = self._clock
            st.first_token_wall = now
        else:
            # amortized burst ITL: j tokens over one gap → j samples
            j = len(fresh)
            gap_s = (self._clock - st.last_emit_step) / j
            gap_w = (now - st.last_emit_wall) / j
            mx["itl_steps"].extend([gap_s] * j)
            mx["itl_wall"].extend([gap_w] * j)
        st.last_emit_step = self._clock
        st.last_emit_wall = now
        st.delivered = n
        return [int(t) for t in fresh]

    def _observe(self, finished) -> List[Event]:
        inner = self.inner
        events: List[Event] = []
        for f in finished:
            st = self._req.get(f.request_id)
            if st is None:
                continue            # submitted around the layer
            toks = self._deliver(f.request_id, f.tokens)
            events.append(Event("finished", f.request_id, toks, f))
            self.completed += 1
            mx = self._metrics_for(st.cls.name)
            mx["completed"] += 1
            mx["preempted_times"] += st.n_preempts
            del self._req[f.request_id]
        resident = [s for s in range(inner.n_slots)
                    if inner._busy[s] and inner._slot_req[s] is not None]
        for s in resident:
            rid = inner._slot_req[s].request_id
            if rid not in self._req:
                continue
            toks = self._deliver(rid, inner.emitted(s))
            if toks:
                events.append(Event("token", rid, toks))
        return events

    # ---------------- metrics -----------------------------------------

    def _metrics_for(self, name: str) -> dict:
        if name not in self._metrics:
            self._metrics[name] = {"ttft_steps": [], "ttft_wall": [],
                                   "itl_steps": [], "itl_wall": [],
                                   "completed": 0, "preempted_times": 0}
        return self._metrics[name]

    @staticmethod
    def _pct(xs: List[float]) -> dict:
        if not xs:
            return {"p50": None, "p99": None, "mean": None, "n": 0}
        a = np.asarray(xs, np.float64)
        return {"p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "mean": float(a.mean()), "n": len(xs)}

    def json_summary(self) -> dict:
        """Per-class latency distributions + layer counters. Steps
        clocks are deterministic (CI asserts on them); wall clocks are
        operator color."""
        classes = {}
        for name, mx in self._metrics.items():
            cls = self.classes.get(name)
            entry = {
                "priority": cls.priority if cls else None,
                "completed": mx["completed"],
                "preempted_times": mx["preempted_times"],
                "ttft_steps": self._pct(mx["ttft_steps"]),
                "itl_steps": self._pct(mx["itl_steps"]),
                "ttft_wall_s": self._pct(mx["ttft_wall"]),
                "itl_wall_s": self._pct(mx["itl_wall"]),
            }
            if cls is not None and cls.ttft_budget is not None:
                met = [t <= cls.ttft_budget for t in mx["ttft_wall"]]
                entry["ttft_attainment"] = (float(np.mean(met))
                                            if met else None)
            classes[name] = entry
        return {
            "classes": classes,
            "preemptions": self.preemptions,
            "replay_mismatches": self.replay_mismatches,
            "completed": self.completed,
            "segment_steps": self.segment_steps,
            "total_steps": self._clock,
            "rounds": self.rounds,
            "host_reads": self.host_reads,
        }
