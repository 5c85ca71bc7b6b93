"""Serving with dynamic control flow, the JAX package's
``examples/serve_decode.py`` in the port: the batch-synchronous loop,
then the continuous-batching scheduler in each of its configurations,
every one holding the greedy tokens of the first:

1. batch-synchronous: prefill a batch, decode greedily with a
   per-sequence EOS early exit;
2. continuous batching: a slot pool decodes requests with different
   budgets, retiring a slot on the device and admitting a queued
   request between segments;
3. the paged KV cache, the block-table kernels (``attn_impl="cuda"``),
   chunked prefill, the prefix cache, speculative decoding, the SLO
   layer with preemption, prefill/decode disaggregation and adaptive
   depth (early exit).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

Weights are random, from a seed, at smoke width, in fp32. It runs on
the card unless ``--device cpu`` is given (the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from .. import bridge
from ..configs import get_config
from ..serve import disagg as disagg_lib
from ..serve import engine
from ..serve import scheduler as sched_lib
from ..serve import slo as slo_lib
from ..serve import speculative as spec_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    # fp32 compute, so that every path's greedy tokens are the same (in
    # bf16 the paths round differently and near-ties may flip); the
    # block-table kernels take head dims 64 and 128: widen the smoke
    # config's heads on the card
    cfg = dataclasses.replace(get_config(args.arch, smoke=True),
                              compute_dtype="float32")
    if args.device != "cpu":
        cfg = dataclasses.replace(cfg, head_dim=64, n_heads=4,
                                  n_kv_heads=2, d_model=128)
    params = bridge.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, cfg.vocab, (args.batch, args.prompt_len)
                          ).astype(np.int32)
    n_slots = max(2, args.batch // 2)
    budgets = [args.max_new if b % 2 else max(1, args.max_new // 4)
               for b in range(args.batch)]

    # ---- batch-synchronous loop ----------------------------------------
    import torch
    t0 = time.perf_counter()
    result = engine.generate_batch_sync(
        params, cfg, torch.from_numpy(prompt).to(params["embed"].device),
        max_new=args.max_new, eos_id=1)
    dt = time.perf_counter() - t0
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} max_new={args.max_new}")
    print(f"[serve] batch-sync loop ran {result.steps} decode steps "
          f"(early exit saves {args.max_new - result.steps}) in "
          f"{dt * 1e3:.0f}ms")
    for b in range(args.batch):
        # lengths counts the EOS token; text_lengths is the usable text
        toks = result.tokens[b, :int(result.lengths[b])].tolist()
        print(f"  seq{b} len={int(result.lengths[b])} "
              f"text={int(result.text_lengths[b])}: {toks[:12]}...")

    def serve(c, **kw):
        """Every request through a scheduler of configuration ``kw``;
        (scheduler, {rid: FinishedRequest})."""
        sched = sched_lib.DecodeScheduler(
            params, c, n_slots=n_slots, prompt_len=args.prompt_len,
            max_new_cap=args.max_new, eos_id=1, **kw)
        for b in range(args.batch):
            sched.submit(prompt[b:b + 1], max_new=budgets[b])
        return sched, {f.request_id: f for f in sched.run_until_drained()}

    # ---- continuous batching: mixed budgets over a small slot pool -----
    t0 = time.perf_counter()
    sched, finished = serve(cfg)
    dt = time.perf_counter() - t0
    print(f"[serve] continuous: {sched.n_slots} slots, {sched.total_steps}"
          f" device steps, occupancy {sched.occupancy * 100:.0f}%, "
          f"{dt * 1e3:.0f}ms ({sched.loop_impl})")
    for rid, f in sorted(finished.items()):
        print(f"  req{rid} budget={budgets[rid]} len={f.length} "
              f"text={f.text_length} eos={f.hit_eos}: "
              f"{f.tokens[:8].tolist()}...")

    def same(got):
        for rid, f in finished.items():
            assert got[rid].tokens.tolist() == f.tokens.tolist(), rid

    # ---- paged KV cache: memory tracks tokens in flight ----------------
    # kv="paged" swaps the per-slot cache columns for block tables: a
    # request holds only the blocks its own budget needs.
    # (CLI: python -m repro_torch.launch.serve ... --kv paged)
    paged, got = serve(cfg, kv="paged", kv_block=8)
    same(got)
    print(f"[serve] paged KV: identical tokens, {paged.free_blocks}/"
          f"{paged.kv_blocks} blocks back on the free-list")

    # ---- the block-table kernels ----------------------------------------
    # attn_impl="cuda" + a paged pool decodes through the paged-attention
    # kernel, reading K/V through the block table (the plain version on
    # the CPU); the dense K/V layout is never gathered.
    # (CLI: ... --kv paged --attn-impl cuda)
    kcfg = dataclasses.replace(cfg, attn_impl="cuda")
    kern, got = serve(kcfg, kv="paged", kv_block=8)
    same(got)
    print(f"[serve] paged-attention kernel ({kern.attn_impl}): identical "
          f"tokens")

    # ---- chunked prefill: admission as bounded work an iteration --------
    # prefill="chunked" admits by assigning a slot and its blocks; the
    # prompt prefills inside the decode loop, chunk_tokens positions an
    # iteration beside one decode token a running slot (the chunk kernel
    # under attn_impl="cuda"). (CLI: ... --prefill chunked --chunk-tokens 5)
    chunk = dict(kv="paged", kv_block=8, prefill="chunked", chunk_tokens=5)
    chunked, got = serve(kcfg, **chunk)
    same(got)
    print(f"[serve] chunked prefill ({chunked.prefill_impl}): identical "
          f"tokens")

    # ---- prefix cache: hot prompts share KV blocks ----------------------
    # prefix_cache=True keys full prompt blocks by a chain hash: a
    # resubmitted prompt maps the cached blocks into its own table and
    # starts prefilling at its first uncached block; the blocks are
    # refcounted (pinned by the index after their request retires).
    # (CLI: ... --prefix-cache --prompt-pool 4)
    pfx = sched_lib.DecodeScheduler(
        params, kcfg, n_slots=n_slots, prompt_len=args.prompt_len,
        max_new_cap=args.max_new, eos_id=1, prefix_cache=True, **chunk)
    for rnd in range(2):                # round 2 hits round 1's blocks
        for b in range(args.batch):
            pfx.submit(prompt[b:b + 1], max_new=budgets[b],
                       request_id=rnd * args.batch + b)
    pf = {f.request_id: f for f in pfx.run_until_drained()}
    for rid, f in finished.items():
        assert pf[rid].tokens.tolist() == f.tokens.tolist()
        assert pf[rid + args.batch].tokens.tolist() == f.tokens.tolist()
    print(f"[serve] prefix cache: identical tokens cold and warm, "
          f"{pfx.prefix_hit_blocks} blocks served from the cache")

    # ---- speculative decoding: draft k, verify once ---------------------
    # speculative=SpecConfig(k=...) drafts k tokens a running slot (the
    # n-gram drafter here), verifies the k+1 window in ONE forward
    # through the block table, and accepts a prefix on the device.
    # (CLI: ... --prefill chunked --spec-k 4)
    spec, got = serve(kcfg, speculative=spec_lib.SpecConfig(
        k=4, drafter="ngram", ngram=2), **chunk)
    same(got)
    print(f"[serve] speculative (k=4, ngram): identical tokens, "
          f"{spec.accepted_tokens}/{spec.drafted_tokens} drafts accepted "
          f"({spec.accept_rate * 100:.0f}%), {spec.total_steps} vs "
          f"{chunked.total_steps} scheduler steps")

    # ---- SLO layer: priorities and block-level preemption ---------------
    # SLOScheduler re-sorts the backlog by (priority, deadline) each round,
    # caps segments at segment_steps, and when the most urgent waiting
    # request cannot get blocks, preempts strictly less urgent residents:
    # their blocks return through the refcounted pool and they replay
    # from the prompt, bit for bit. (CLI: ... --stream --hi-every 4)
    tight = sched_lib.DecodeScheduler(
        params, kcfg, n_slots=n_slots, prompt_len=args.prompt_len,
        max_new_cap=args.max_new, eos_id=1,
        kv_blocks=2 * ((args.prompt_len + args.max_new) // 8 + 1),
        **chunk)
    slo = slo_lib.SLOScheduler(tight, segment_steps=4)
    for b in range(args.batch - 1):
        slo.submit(prompt[b:b + 1], max_new=budgets[b], slo_class="batch",
                   request_id=b)
    evs = slo.step()                    # batch traffic takes the pool
    slo.submit(prompt[-1:], max_new=budgets[-1], slo_class="interactive",
               request_id=args.batch - 1)
    streams = {b: [] for b in range(args.batch)}
    evs += slo.run_until_drained()
    for e in evs:
        if e.kind in ("token", "finished"):
            streams[e.request_id].extend(e.tokens)
    assert slo.replay_mismatches == 0
    for rid, f in finished.items():     # preemption never changed a bit
        assert streams[rid] == f.tokens.tolist()
    summary = slo.json_summary()["classes"]
    print(f"[serve] SLO layer: {slo.preemptions} preemption(s), "
          f"interactive TTFT p50 "
          f"{summary['interactive']['ttft_steps']['p50']:.0f} steps vs "
          f"batch {summary['batch']['ttft_steps']['p50']:.0f}, all "
          f"{slo.completed} requests completed")

    # ---- disaggregation: a prefill tier and a decode tier --------------
    # DisaggScheduler routes every request through TWO schedulers: a
    # prefill tier (chunked flash-prefill admission, no decode) and a
    # decode tier (the paged-attention kernel). A finished prompt's KV
    # blocks are copied into a fresh buffer on a side stream and spliced
    # into a decode slot one round later, the decode tier's stream
    # waiting on the copy's event. Both tiers share this one device (and
    # its weights), as the JAX package's do with one device; the router,
    # the ship and the splice are the ones a split across devices would
    # run. Tokens are still identical.
    # (CLI: ... --disagg --prefill-slots 2)
    dis = disagg_lib.DisaggScheduler(
        params, kcfg, n_prefill_slots=2, n_decode_slots=n_slots,
        prompt_len=args.prompt_len, max_new_cap=args.max_new, eos_id=1,
        kv_block=8, chunk_tokens=5)
    for b in range(args.batch):
        dis.submit(prompt[b:b + 1], max_new=budgets[b])
    same({f.request_id: f for f in dis.run_until_drained()})
    print(f"[serve] disaggregated ({dis.transfer_impl}): identical tokens, "
          f"{dis.transfers} KV shipments "
          f"({dis.transfer_bytes / 1024:.0f} KiB), {dis.prefill_steps} "
          f"prefill-tier + {dis.total_steps} decode-tier steps")

    # ---- adaptive depth: confident tokens stop running layers ----------
    # early_exit=True runs the decode layer loop while any row is live:
    # after each block the model's own unembed scores the hidden state,
    # and rows whose top1 - top2 logit margin clears exit_threshold halt;
    # their K/V for the skipped layers is filled from the halting layer's
    # hidden state. Inside a captured segment each layer sits behind an
    # IF node. The default threshold (inf) never halts a row and gives
    # the non-adaptive tokens bit for bit; a finite one trades fidelity
    # for depth. (CLI: ... --early-exit --exit-threshold 0.05)
    acfg = dataclasses.replace(cfg, early_exit=True)   # threshold = inf
    ada, got = serve(acfg)
    same(got)
    print(f"[serve] adaptive depth (threshold=inf, {ada.depth_impl}): "
          f"identical tokens, mean {ada.mean_depth:.1f} layers/token of "
          f"{cfg.n_layers} (no row ever halted)")
    fast, _ = serve(dataclasses.replace(acfg, exit_threshold=0.05))
    print(f"[serve] adaptive depth (threshold=0.05): mean "
          f"{fast.mean_depth:.2f} layers/token, confident tokens exited "
          f"early")
    for s in (sched, paged, kern, chunked, pfx, spec, tight, dis, ada, fast):
        s.close()


if __name__ == "__main__":
    main()
