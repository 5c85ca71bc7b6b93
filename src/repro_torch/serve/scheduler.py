"""Slot-based continuous-batching decode scheduler: one-shot or
chunked admission.

Port of ``repro/serve/scheduler.py`` (admission, the decode segment,
harvest). The engine owns a fixed pool of ``n_slots`` decode slots,
each one row of a shared cache (attention K/V, or a pure-SSM model's
conv and h state) plus per-slot registers on the device (``cur_len``,
``n_emitted``, ``budget``, ``active``, ``done`` ...).

Two admission modes:

- ``prefill="oneshot"`` (the default, as in the JAX package): FREE ->
  RUNNING in one admission call, which prefills every admitted prompt
  in ONE ``engine.prefill`` over the ``n_slots``-wide permuted batch
  and samples each first token at the row's last real position. Dense
  prompts are right-padded to a power-of-two bucket; SSM prompts must
  be exactly ``prompt_len`` long (a recurrence keeps folding pad lanes
  into its state). SSM state comes back fresh from the prefill and is
  spliced into the pool along the slot axis.
- ``prefill="chunked"`` (dense family only): FREE -> PREFILLING
  (assigned at admission: registers and block tables, no model forward)
  -> RUNNING. Every iteration of a segment advances each prefilling slot
  by at most ``chunk_tokens`` prompt positions (``engine.prefill_chunk``,
  through the flash-prefill kernel when the cache is paged and
  ``cfg.attn_impl == "cuda"``); a slot whose chunk covers its last
  prompt position samples its first token and decodes in the same
  iteration.

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

Per-request greedy outputs equal ``engine.generate_batch_sync``'s, and
are identical between ``kv="dense"`` and ``kv="paged"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import core, kernels
from ..core import device_loop
from ..kernels.flash_prefill import kernel as fp_kernel
from ..kernels.paged_attention import kernel as pa_kernel
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


@dataclasses.dataclass
class _Queued:
    request_id: int
    prompt: np.ndarray       # (1, L) int32, 1 <= L <= prompt_len
    max_new: int
    key: Optional[np.ndarray] = None  # (2,) uint32 words; None: derived


class DecodeScheduler:
    """Continuous-batching host loop over a slot pool.

    Args:
      params / cfg: the port's parameters (``bridge``) and config; the
        pool lives on the parameters' device, ``cfg.attn_impl`` selects
        the attention path and ``cfg.ssm.scan_impl`` the scan.
      n_slots: decode slots (rows of the cache).
      prompt_len: longest prompt accepted (the only length accepted for
        a pure-SSM model in one-shot mode).
      max_new_cap: largest per-request ``max_new``.
      admit_threshold: one-shot coalescing: while some slot is busy,
        wait until this many requests (or the whole queue) can be
        admitted in one prefill.
      kv: "dense" or "paged" KV cache; ``kv_block``/``kv_blocks`` size
        the paged pool (default: dense-equivalent capacity).
      prefill: "oneshot" (default) or "chunked" (dense family only).
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
                 draft_params=None, draft_cfg=None):
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
            if cfg.family != "dense":
                raise ValueError(
                    f"prefill='chunked' requires an attention-decoder "
                    f"family; family {cfg.family!r} prefills through a "
                    f"full-prompt forward")
            if chunk_tokens < 1:
                raise ValueError("chunk_tokens must be >= 1")
        if loop not in (None, "graph", "host"):
            raise ValueError(f"loop must be None, 'graph' or 'host'; got "
                             f"{loop!r}")
        if speculative is not None:
            spec_lib.validate(speculative, cfg, prefill, draft_cfg,
                              draft_params)
        elif draft_params is not None or draft_cfg is not None:
            raise ValueError("draft_params/draft_cfg need "
                             "speculative=SpecConfig(drafter='model')")
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
        self.max_len = prompt_len + max_new_cap + 1
        self.prefill = prefill
        self._chunked = prefill == "chunked"
        self.chunk_tokens = int(chunk_tokens)
        self.kv, self.kv_block = kv, kv_block
        self.kv_blocks = (n_slots * kvc.blocks_needed(self.max_len, kv_block)
                          if kv_blocks is None else int(kv_blocks))
        self._kv_key = engine.kv_key(cfg)
        # Right padding is exact only for attention prefills (causal
        # masking keeps real tokens blind to pad lanes); an SSM
        # recurrence folds the pad tail into its state, so pure-SSM
        # prompts must have exactly prompt_len tokens.
        self._bucketed = cfg.family == "dense"
        self._next_rid = 0
        self.queue: List[_Queued] = []
        # host mirrors of slot occupancy and (paged) free blocks, kept
        # in step with the device so admission never reads the device
        self._busy = np.zeros(n_slots, bool)
        self._slot_blocks = np.zeros(n_slots, np.int64)
        self._free_blocks = self.kv_blocks
        self.tokens_emitted = 0
        # run counters: host reads (flag reads and harvests), segments,
        # graph launches; the device counters as last harvested
        self.host_reads = self.segments = self.graph_replays = 0
        self._counts = np.zeros(4, np.int64)
        self._launches = np.zeros(len(_COUNTED), np.int64)
        # slot_accepted and slot_windows as last harvested
        self._spec_counts = np.zeros((2, n_slots), np.int64)
        self._per_branch: Dict[str, List[int]] = {}  # counts at capture
        self._loop: Optional[device_loop.DeviceLoop] = None
        self.capture_seconds = 0.0     # wall time of the segment's capture
        self.pool = self._init_pool()
        # the host buffer of each segment's want/max_steps write
        self._limits = torch.zeros(2, dtype=torch.int32)
        if self.device.type == "cuda":
            self._limits = self._limits.pin_memory()

    # ---------------- pool construction ----------------

    def _init_pool(self) -> SlotPool:
        n, dev = self.n_slots, self.device

        def z(*shape, dtype=torch.int32, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        return SlotPool(
            cache=engine.make_cache(self.cfg, n, self.max_len,
                                    kv_impl=self.kv, kv_block=self.kv_block,
                                    kv_blocks=self.kv_blocks, device=dev),
            next_token=z(n), cur_len=z(n, fill=1), n_emitted=z(n),
            budget=z(n), active=z(n, dtype=torch.bool),
            done=z(n, dtype=torch.bool), request_id=z(n, fill=-1),
            keys=z(n, 2, dtype=torch.int64), out=z(n, self.max_new_cap),
            prompt=z(n, self.prompt_len if self._chunked else 0),
            plen=z(n), pf_pos=z(n), prefilling=z(n, dtype=torch.bool),
            draft=(engine.make_cache(self.draft_cfg, n, self.max_len,
                                     device=dev)
                   if self.draft_cfg is not None else {}),
            steps=z(), slot_steps=z(), chunk_steps=z(), decode_steps=z(),
            launches=z(len(_COUNTED), dtype=torch.int64),
            slot_accepted=z(n), slot_windows=z(n), limits=z(2),
            seg_start=z())

    # ---------------- device-side steps -------------------------------

    # Both admissions take ``slots``, a permutation of the slot ids
    # whose ``mask``ed entries are the free slots being filled; the other
    # entries rewrite their own values.

    def _reserve(self, slots, budget, mask) -> None:
        """Release whatever the freed slots last held, then reserve each
        admitted request's budget of positions (nothing to do without a
        K/V cache)."""
        if self._kv_key is not None:
            node = self.pool.cache[self._kv_key]
            node.free(slots, mask=mask)
            node.alloc(slots, budget, mask=mask)

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
               derive, mask) -> None:
        """One-shot admission: up to n requests in ONE prefill. prompts
        (n, Sb) right-padded to the bucket width Sb; true_lens (n,) real
        prompt lengths. Unmasked rows keep their slot: no K/V write
        (masked in the prefill) and their own state spliced back."""
        p, n = self.pool, self.n_slots
        self._reserve(slots, true_lens + max_news + 1, mask)
        logits, fresh = engine.prefill(self.params, self.cfg, prompts,
                                       p.cache, rows=slots, mask=mask)
        # the first token comes from each row's LAST REAL position
        # (bucketed rows are right-padded), at emission index 0
        rows = torch.arange(n, device=self.device)
        rkeys = self._request_keys(rids, keys, derive)
        tok0 = sampling_lib.sample_slots(
            logits[rows, (true_lens - 1).long()],
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
        self._register(slots, mask, next_token=tok0, cur_len=true_lens + 1,
                       n_emitted=zeros, budget=max_news,
                       active=torch.ones_like(mask), done=zeros.bool(),
                       request_id=rids, keys=rkeys,
                       out=torch.zeros_like(p.out))

    def _assign(self, prompts, plens, slots, rids, max_news, keys, derive,
                mask) -> None:
        """Chunked admission: reserve the slots' blocks and register the
        requests as PREFILLING; no model forward."""
        self._reserve(slots, plens + max_news + 1, mask)
        zeros = torch.zeros_like(rids)
        self._register(slots, mask, next_token=zeros, cur_len=zeros + 1,
                       n_emitted=zeros, budget=max_news,
                       active=zeros.bool(), done=zeros.bool(),
                       request_id=rids,
                       keys=self._request_keys(rids, keys, derive),
                       out=torch.zeros_like(self.pool.out),
                       prompt=prompts, plen=plens, pf_pos=zeros,
                       prefilling=torch.ones_like(mask))

    def _chunk(self) -> None:
        """Advance every PREFILLING slot by one chunk; a slot whose
        chunk covers its last prompt position samples its first token
        there and turns RUNNING. Registers are written in place (a
        captured graph keeps their addresses)."""
        p, C, n = self.pool, self.chunk_tokens, self.n_slots
        logits = engine.prefill_chunk(self.params, self.cfg, p.prompt,
                                      p.cache, p.pf_pos, chunk=C,
                                      mask=p.prefilling)
        if p.draft:
            # the draft model prefills the same chunk into its own cache;
            # its logits are not used (the first token is the target's)
            engine.prefill_chunk(self._draft_params, self.draft_cfg,
                                 p.prompt, p.draft, p.pf_pos, chunk=C,
                                 mask=p.prefilling)
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
        p.active.copy_(p.active | fin)

    def _finishing(self, p: SlotPool) -> torch.Tensor:
        """The prefilling slots whose next chunk covers their last prompt
        position."""
        return p.prefilling & (p.pf_pos + self.chunk_tokens >= p.plen)

    def _decode(self) -> None:
        """Emit each RUNNING slot's pending token, retire slots that hit
        EOS or their budget (freeing their blocks on the device), and
        decode every slot one token. In chunked mode appends are gated
        to emitting rows: a mid-prefill slot's stale ``cur_len`` points
        into its prompt. In one-shot mode idle rows may write garbage:
        admission rewrites a row's cache before it is read again.
        Registers are written in place."""
        p, n = self.pool, self.n_slots
        tok, emit = p.next_token, p.active
        rows = torch.arange(n, device=self.device)
        idx = p.n_emitted.clamp(0, self.max_new_cap - 1).long()
        p.out[rows, idx] = torch.where(emit, tok, p.out[rows, idx])
        p.n_emitted.add_(emit.int())
        finished = emit & ((tok == self.eos_id) | (p.n_emitted >= p.budget))
        active = emit & ~finished      # a new tensor: ``emit`` is a register
        if self._kv_key is not None:
            p.cache[self._kv_key].free(mask=finished)
        logits = engine.decode_step(self.params, self.cfg, tok[:, None],
                                    p.cache, p.cur_len,
                                    write_mask=emit if self._chunked
                                    else None)
        nxt = sampling_lib.sample_slots(
            logits[:, 0], self._keys_at(p.keys, p.n_emitted), self.sampling)
        p.next_token.copy_(torch.where(active, nxt, tok))
        p.cur_len.add_(active.int())
        p.active.copy_(active)
        p.done.copy_(p.done | finished)

    def _spec_decode(self) -> None:
        """One draft-k / verify-once iteration for every RUNNING slot (the
        JAX package's ``spec_decode_fn``): draft, score the window
        ``[pending, d_1..d_k]`` in one ``verify_step`` at ``cur_len - 1``,
        accept a prefix, and emit ``m = min(accepted + 1, room, up to the
        first EOS)`` tokens; ``cur_len`` advances by m. Rejected drafts
        are not rolled back: their lanes lie at or past the new
        ``cur_len - 1``, where the next window writes before it reads. A
        slot that finishes retires and frees its blocks here. Registers
        are written in place."""
        p, n, k = self.pool, self.n_slots, self.speculative.k
        cap, eos = self.max_new_cap, self.eos_id
        emit, t0 = p.active, p.next_token
        dev = self.device
        if not p.draft:
            drafts = spec_lib.draft_ngram(p.prompt, p.plen, p.out,
                                          p.n_emitted, t0, k=k,
                                          ngram=self.speculative.ngram)
        else:
            # k+1 greedy draft steps: the draft cache's valid prefix then
            # ends at the window's end, and the next window rewrites
            # whatever lies past the accepted point
            toks, tok = [], t0
            for j in range(k + 1):
                dl = engine.decode_step(self._draft_params, self.draft_cfg,
                                        tok[:, None], p.draft, p.cur_len + j,
                                        write_mask=emit)
                tok = torch.argmax(dl[:, 0], dim=-1).to(torch.int32)
                if j < k:
                    toks.append(tok)
            drafts = torch.stack(toks, dim=1)
        window = torch.cat([t0[:, None], drafts], dim=1)           # (n, k+1)
        logits = engine.verify_step(self.params, self.cfg, window, p.cache,
                                    p.cur_len, write_mask=emit)
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
        p.n_emitted.copy_(n_emitted)
        p.next_token.copy_(torch.where(active, nxt, t0))
        p.cur_len.add_(m.int())
        p.active.copy_(active)
        p.done.copy_(p.done | finished)

    def _chunk_branch(self) -> None:
        self._chunk()
        self.pool.chunk_steps.add_(1)

    def _decode_body(self) -> None:
        """The decode branch's work: a speculative window or one token."""
        if self.speculative is not None:
            self._spec_decode()
        else:
            self._decode()

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
        idle = self.n_slots - busy.sum()
        return busy.any() & (idle < p.limits[0]) & \
            (p.steps - p.seg_start < p.limits[1])

    def _seg_body(self, p: SlotPool) -> SlotPool:
        if self._chunked:
            core.cond(p.prefilling.any(), self._captured_branch(
                self._chunk_branch, "chunk"), _noop, backend="graph")
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
        flags = torch.stack([self._seg_cond(p), p.prefilling.any(),
                             (p.active | self._finishing(p)).any()])
        self.host_reads += 1
        return device_loop.read_host(flags)[0].tolist()

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
        no-op there: masked writes, unchanged registers), so that lazy
        initialisation (the kernels' build, cuBLAS, cached constants)
        happens before capture; then capture the segment loop, with the
        kernel launches counted on the device."""
        if self._busy.any():
            raise RuntimeError("the segment is captured on an idle pool")
        with torch.no_grad():
            if self._chunked:
                self._chunk()
            self._decode_body()
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
        """Host mirror of the paged free-list (pool capacity for dense)."""
        return int(self._free_blocks)

    @property
    def active_count(self) -> int:
        return int(self._busy.sum())

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in slots)."""
        return len(self.queue) + int(self._busy.sum())

    def blocks_for(self, true_len: int, max_new: int) -> int:
        """Blocks a request holds while resident (0 for dense); agrees
        with the device-side alloc of ``true_len + max_new + 1``."""
        if self.kv != "paged":
            return 0
        return int(kvc.blocks_needed(true_len + max_new + 1, self.kv_block))

    def submit(self, prompt, *, max_new: int,
               request_id: Optional[int] = None, key=None) -> int:
        """Queue one request. prompt: (1, L) int, 1 <= L <= prompt_len
        (L == prompt_len for a pure-SSM model). key: the request's PRNG
        key, two uint32 words (a JAX raw key); None derives
        ``fold_in(PRNGKey(seed), request_id)`` at admission."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 2 or prompt.shape[0] != 1 or \
                not 1 <= prompt.shape[1] <= self.prompt_len:
            raise ValueError(f"prompt must be (1, L) with 1 <= L <= "
                             f"{self.prompt_len}; got {prompt.shape}")
        if not self._bucketed and prompt.shape[1] != self.prompt_len:
            raise ValueError(
                f"family {self.cfg.family!r} requires exact-length "
                f"prompts (1, {self.prompt_len}): right-padding is not "
                f"exact for SSM state; got {prompt.shape}")
        if not 1 <= max_new <= self.max_new_cap:
            raise ValueError(f"max_new must be in [1, {self.max_new_cap}]")
        need = self.blocks_for(prompt.shape[1], max_new)
        if need > self.kv_blocks:
            raise ValueError(
                f"request needs {need} cache blocks but the paged pool "
                f"only has kv_blocks={self.kv_blocks}")
        if not self.queue and not self._busy.any():
            # first submission of a fresh run on a drained scheduler:
            # counters describe runs, not scheduler lifetimes
            self.reset_stats()
        rid = self._next_rid if request_id is None else int(request_id)
        self._next_rid = max(self._next_rid, rid) + 1
        if key is not None:
            key = np.asarray(key, np.int64).reshape(2) & 0xFFFFFFFF
        self.queue.append(_Queued(rid, prompt.astype(np.int32),
                                  int(max_new), key))
        return rid

    def _bucket(self, length: int) -> int:
        """Power-of-two prefill bucket for a prompt length (one-shot)."""
        if not self._bucketed:
            return self.prompt_len
        b = 1
        while b < length:
            b <<= 1
        return min(b, self.prompt_len)

    def _admit_queued(self) -> int:
        """Fill free slots from the queue, FIFO, while each request's
        blocks fit the free-list (head-of-line blocking keeps order).
        ``admit_threshold > 1`` coalesces: while some slot is busy, a
        batch smaller than the threshold (and than what the queue
        holds) waits for a later round."""
        if not self.queue or self.free_slots == 0:
            return 0
        batch: List[_Queued] = []
        blocks_free = self._free_blocks
        while self.queue and len(batch) < self.free_slots:
            q = self.queue[0]
            need = self.blocks_for(q.prompt.shape[1], q.max_new)
            if need > blocks_free:
                break
            blocks_free -= need
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
        free = np.nonzero(~self._busy)[0]
        slots = np.concatenate([free, np.nonzero(self._busy)[0]])
        mask = np.zeros(n, bool)
        mask[:k] = True
        prompts = np.zeros((n, L), np.int32)
        plens = np.full(n, L, np.int32)
        rids = np.full(n, -1, np.int32)
        max_news = np.zeros(n, np.int32)
        keys = np.zeros((n, 2), np.int64)
        derive = np.zeros(n, bool)
        for i, q in enumerate(batch):
            tl = q.prompt.shape[1]
            prompts[i, :tl] = q.prompt[0]
            plens[i] = tl
            rids[i] = q.request_id
            max_news[i] = q.max_new
            if q.key is None:
                derive[i] = True
            else:
                keys[i] = q.key

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        admit = self._assign if self._chunked else self._admit
        admit(dev(prompts), dev(plens), dev(slots.astype(np.int32)),
              dev(rids), dev(max_news), dev(keys), dev(derive), dev(mask))
        for i, q in enumerate(batch):
            slot = int(free[i])
            need = self.blocks_for(q.prompt.shape[1], q.max_new)
            self._busy[slot] = True
            self._slot_blocks[slot] = need
            self._free_blocks -= need
        return k

    def _harvest(self) -> List[FinishedRequest]:
        """ONE host read per segment: ``done``, the emissions, the
        request ids and the device counters."""
        p = self.pool
        (done, out, n_emitted, rids, *counts, launches, accepted,
         windows) = device_loop.read_host(
            p.done, p.out, p.n_emitted, p.request_id, p.steps,
            p.slot_steps, p.chunk_steps, p.decode_steps, p.launches,
            p.slot_accepted, p.slot_windows)
        self.host_reads += 1
        self._spec_counts = np.stack([accepted, windows]).astype(np.int64)
        self._counts = np.array([int(c) for c in counts], np.int64)
        # the launches graph segments made since the last harvest (an
        # eager launch was counted in Python when it was made)
        for (o, a), k in zip(_LAUNCH_COUNTERS, launches - self._launches):
            setattr(o, a, getattr(o, a) + int(k))
        self._launches = launches.astype(np.int64)
        got = []
        for slot in np.nonzero(done)[0]:
            length = int(n_emitted[slot])
            toks = out[slot, :length].copy()
            hit_eos = length > 0 and int(toks[-1]) == self.eos_id
            got.append(FinishedRequest(
                request_id=int(rids[slot]), tokens=toks, length=length,
                text_length=length - int(hit_eos), hit_eos=hit_eos))
            self.tokens_emitted += length
            self._busy[slot] = False
            # the device freed these blocks at retirement; the host
            # mirror learns here, before the next admission
            self._free_blocks += int(self._slot_blocks[slot])
            self._slot_blocks[slot] = 0
        return got

    def step(self, expect_arrivals: bool = False,
             max_steps: Optional[int] = None) -> List[FinishedRequest]:
        """One scheduling round: admit -> segment -> harvest. With an
        empty queue the segment drains (retirements do not pause it)
        unless ``expect_arrivals``: then it returns as soon as a slot
        frees, so a request arriving mid-drain is admitted promptly.
        ``max_steps`` additionally caps the segment's iterations (None:
        no cap)."""
        if self._graph and self._loop is None and not self._busy.any():
            self._capture()
        self._admit_queued()
        if self.active_count == 0:
            return []
        if not self.queue and not expect_arrivals:
            want = self.n_slots + 1          # drain: never pause
        else:
            # return once enough slots have freed beyond those idle at
            # entry (idle slots the queue could not fill do not count)
            fresh = (min(self.admit_threshold, len(self.queue))
                     if self.queue else self.admit_threshold)
            want = self.free_slots + fresh
        self._segment(want, _NO_STEP_CAP if max_steps is None
                      else int(max_steps))
        return self._harvest()

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
        for t in (p.steps, p.slot_steps, p.chunk_steps, p.decode_steps,
                  p.launches, p.slot_accepted, p.slot_windows):
            t.zero_()
        self._counts[:] = 0
        self._launches[:] = 0
        self._spec_counts[:] = 0
        self.tokens_emitted = 0
        self.host_reads = self.segments = self.graph_replays = 0

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

    @property
    def attn_impl(self) -> str:
        return engine.resolved_attn_impl(
            self.cfg, self.kv, self.device,
            verify=self.speculative is not None)

    @property
    def prefill_impl(self) -> str:
        return engine.resolved_prefill_impl(self.cfg, self.kv, self.prefill,
                                            self.device)


def _noop() -> None:
    """The untaken side of a branch: the pool is updated in place."""
