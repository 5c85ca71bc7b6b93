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
from repro_torch.serve import scheduler as sched_lib


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


def run_continuous(args, cfg, params, workload):
    cap = max(m for _, m in workload)
    sched = sched_lib.DecodeScheduler(
        params, cfg, n_slots=args.slots, prompt_len=args.prompt_len,
        max_new_cap=cap, eos_id=args.eos_id, kv=args.kv,
        kv_block=args.kv_block, kv_blocks=args.kv_blocks,
        prefill=args.prefill, chunk_tokens=args.chunk_tokens)
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
            "graph_replays": sched.graph_replays}


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
    ap.add_argument("--seed", type=int, default=0)
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
    return cont


if __name__ == "__main__":
    main()
