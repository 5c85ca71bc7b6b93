"""Serving launcher: continuous-batching request-queue loop.

Port of the continuous path of ``repro/launch/serve.py``. Drives
``serve.scheduler.DecodeScheduler`` against a Poisson arrival process
(alternating short/long ``max_new``) and reports aggregate tokens/s,
p50/p99 request latency and slot occupancy, with the decode and
prefill attention paths that actually ran ("attention-free" for a
pure-SSM model) and the segment loop's lowering (``cuda-graph:while``
on the card: each segment one graph launch and one host read;
``host-read`` on the CPU) with its segments, host reads and graph
launches:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --slots 8 --prompt-len 512 --requests 16 --kv paged \
        --attn-impl cuda --prefill chunked --chunk-tokens 128

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --slots 8 --prompt-len 512 --requests 16 \
        --prefill oneshot

``--temperature T`` (with ``--top-k K``) samples instead of taking the
argmax: each request draws from its own threefry key,
``fold_in(PRNGKey(--seed), request_id)``, bit-equal to the JAX
package's. ``--spec-k K`` (with ``--prefill chunked``) turns on
speculative decoding: each decode iteration drafts K tokens per running
slot (``--spec-drafter ngram``: prompt lookup over the slot's own prompt
and emissions, matching ``--spec-ngram`` tokens; ``--spec-drafter model
--draft-arch A``: K+1 greedy steps of a small model with the target's
vocab, riding its own cache) and verifies them in ONE target forward
(through the chunk kernel's ``flash_verify`` entry under ``--attn-impl
cuda --kv paged``); the report adds the accept rate and the mean accept
length:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --slots 8 --prompt-len 512 --requests 16 --kv paged \
        --attn-impl cuda --prefill chunked --chunk-tokens 128 --spec-k 4

``--prefill oneshot`` (the default) admits prompts through one prefill
per admission round; a pure-SSM model takes only this mode, with
prompts of exactly ``--prompt-len`` tokens. The selective scan's path
comes from the config's ``ssm.scan_impl`` (falcon-mamba-7b ships
``"assoc"``; ``"cuda"`` runs the hand-written kernel), as in the JAX
package, which has no flag for it either.

Weights are random, drawn from a seed (``bridge.init_params``). Runs on
the card; ``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import sampling as sampling_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib


def build_workload(args, rng):
    """[(arrival_s, max_new)] sorted by arrival: Poisson arrivals,
    alternating short/long ``max_new``."""
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                         size=args.requests))
    return [(float(arrivals[i]),
             args.max_new_short if i % 2 == 0 else args.max_new_long)
            for i in range(args.requests)]


def pctl(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def speculation(args):
    """(SpecConfig or None, draft params, draft config) from the flags."""
    if not args.spec_k:
        return None, None, None
    spec = spec_lib.SpecConfig(k=args.spec_k, drafter=args.spec_drafter,
                               ngram=args.spec_ngram)
    if args.spec_drafter != "model":
        return spec, None, None
    if not args.draft_arch:
        raise SystemExit("--spec-drafter model needs --draft-arch")
    draft_cfg = get_config(args.draft_arch, smoke=args.smoke)
    return spec, bridge.init_params(draft_cfg, seed=1,
                                    device=args.device), draft_cfg


def run_continuous(args, cfg, params, workload):
    cap = max(m for _, m in workload)
    spec, draft_params, draft_cfg = speculation(args)
    sched = sched_lib.DecodeScheduler(
        params, cfg, n_slots=args.slots, prompt_len=args.prompt_len,
        max_new_cap=cap, eos_id=args.eos_id, kv=args.kv,
        kv_block=args.kv_block, kv_blocks=args.kv_blocks,
        prefill=args.prefill, chunk_tokens=args.chunk_tokens,
        sampling=sampling_lib.SamplingParams(temperature=args.temperature,
                                             top_k=args.top_k),
        seed=args.seed, speculative=spec, draft_params=draft_params,
        draft_cfg=draft_cfg)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(2, cfg.vocab, (1, args.prompt_len)).astype(
        np.int32) for _ in workload]
    # Warm-up request outside the timed window: loads the kernels and
    # the math libraries on the device.
    sched.submit(prompts[0], max_new=2, request_id=-1)
    sched.run_until_drained()
    _sync(sched.device)
    sched.reset_stats()

    arrival_wall, finish_wall = {}, {}
    t0 = time.perf_counter()
    next_req = 0
    idle_s = 0.0          # open-loop arrival gaps: excluded from tok/s
    while len(finish_wall) < len(workload):
        now = time.perf_counter() - t0
        while next_req < len(workload) and workload[next_req][0] <= now:
            rid = sched.submit(prompts[next_req],
                               max_new=workload[next_req][1],
                               request_id=next_req)
            arrival_wall[rid] = workload[next_req][0]
            next_req += 1
        if sched.pending == 0:
            if next_req < len(workload):
                gap = max(0.0, workload[next_req][0] - now)
                time.sleep(gap)
                idle_s += gap
            continue
        for f in sched.step(expect_arrivals=next_req < len(workload)):
            finish_wall[f.request_id] = time.perf_counter() - t0
    _sync(sched.device)
    wall = time.perf_counter() - t0
    busy = max(wall - idle_s, 1e-9)
    lat = [finish_wall[r] - arrival_wall[r] for r in finish_wall]
    toks = sched.tokens_emitted
    sched.close()
    return {"wall_s": wall, "busy_s": busy, "tok_s": toks / busy,
            "p50_s": pctl(lat, 50), "p99_s": pctl(lat, 99),
            "occupancy": sched.occupancy, "steps": sched.total_steps,
            "tokens": toks, "attn_impl": sched.attn_impl,
            "prefill_impl": sched.prefill_impl,
            "loop_impl": sched.loop_impl, "segments": sched.segments,
            "host_reads": sched.host_reads,
            "graph_replays": sched.graph_replays,
            "spec_windows": sched.spec_windows,
            "accepted_tokens": sched.accepted_tokens,
            "drafted_tokens": sched.drafted_tokens,
            "accept_rate": sched.accept_rate,
            "mean_accept_len": sched.mean_accept_len}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--max-new-short", type=int, default=8)
    ap.add_argument("--max-new-long", type=int, default=32)
    ap.add_argument("--eos-id", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep exactly this many candidates before "
                         "sampling (0: all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the workload and the requests' PRNG keys")
    ap.add_argument("--kv", choices=("dense", "paged"), default="dense",
                    help="KV-cache layout: 'paged' bounds cache memory "
                         "by tokens in flight (block tables)")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="paged cache block size (tokens)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged pool capacity in blocks (default: "
                         "dense-equivalent)")
    ap.add_argument("--attn-impl", choices=("gather", "cuda"), default=None,
                    help="attention path: 'cuda' + --kv paged runs the "
                         "block-table kernels; default keeps the "
                         "config's setting (gather)")
    ap.add_argument("--prefill", choices=("oneshot", "chunked"),
                    default="oneshot",
                    help="admission mode: 'oneshot' prefills each "
                         "admission round's prompts in one forward; "
                         "'chunked' (dense models) prefills them inside "
                         "the decode loop, <= --chunk-tokens positions "
                         "per step")
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="chunked-prefill chunk size")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft this many tokens "
                         "per decode iteration and verify them in ONE "
                         "target forward (needs --prefill chunked; 0: "
                         "off); greedy streams stay those of plain decode")
    ap.add_argument("--spec-drafter", choices=("ngram", "model"),
                    default="ngram",
                    help="'ngram': look the continuation up in the slot's "
                         "own prompt and emissions; 'model': greedy steps "
                         "of --draft-arch on its own cache")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="n-gram drafter match length")
    ap.add_argument("--draft-arch", default=None,
                    help="draft model for --spec-drafter model (the "
                         "target's vocab; random weights from seed 1)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    params = bridge.init_params(cfg, seed=0, device=args.device)
    workload = build_workload(args, np.random.default_rng(args.seed))
    cont = run_continuous(args, cfg, params, workload)
    print(f"[serve] continuous (decode {cont['attn_impl']}, "
          f"prefill {cont['prefill_impl']}): "
          f"{cont['tokens']} tokens, "
          f"{cont['wall_s']:.2f}s wall ({cont['busy_s']:.2f}s busy) -> "
          f"{cont['tok_s']:.1f} tok/s | "
          f"latency p50 {cont['p50_s'] * 1e3:.0f}ms "
          f"p99 {cont['p99_s'] * 1e3:.0f}ms | "
          f"occupancy {cont['occupancy'] * 100:.0f}% "
          f"({cont['steps']} device steps) | loop {cont['loop_impl']}: "
          f"{cont['segments']} segments, {cont['host_reads']} host reads, "
          f"{cont['graph_replays']} graph launches")
    if args.spec_k:
        print(f"[serve] speculative (k={args.spec_k}, {args.spec_drafter}): "
              f"{cont['accepted_tokens']}/{cont['drafted_tokens']} drafts "
              f"accepted (accept rate {cont['accept_rate'] * 100:.0f}%), "
              f"mean accept length {cont['mean_accept_len']:.2f}, "
              f"{cont['tok_s']:.1f} tok/s")
    return cont


if __name__ == "__main__":
    main()
