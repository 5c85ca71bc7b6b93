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

``--prefix-cache`` (with ``--prefill chunked --kv paged``) shares full
prompt blocks between requests: a repeated prompt maps the cached blocks
into its own table and starts prefilling at its first uncached block;
``--prompt-pool P`` draws the prompts from P distinct ones (the traffic
it serves). ``--trace FILE`` replays a CSV of
``arrival_s,max_new`` lines instead of Poisson arrivals. The report
gives TTFT and inter-token p50/p99 from host timestamps taken when the
tokens reach the host (each harvest; a burst of j tokens over a gap g
counts j gaps of g/j):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --slots 8 --prompt-len 512 --requests 16 --kv paged \
        --attn-impl cuda --prefill chunked --chunk-tokens 128 \
        --prefix-cache --prompt-pool 4 --compare

``--early-exit`` (with ``--exit-threshold T --exit-min-layers M``) turns
on confidence-based early exit: a row whose shared-unembed top1 - top2
logit margin clears T after at least M layers stops running layers, and
the K/V of the layers it skips is filled from its hidden state;
``--mod-capacity C --mod-every N`` turns on mixture-of-depths routing
(zero-initialised routers), on the dense, MoE (``--arch
qwen2-moe-a2.7b``) and VLM (``--arch internvl2-1b``) families. The
report adds the mean layers a token, per
``max_new`` class, and the lowering of the layer loop
(``cuda-graph:if-per-layer`` inside a graph segment, ``host-read``
otherwise). Threshold inf (the default) runs the halt machinery and
emits the non-adaptive streams bit for bit.

``--compare`` always runs the batch-synchronous baseline
(``engine.generate_batch_sync``, back to back at equal slot count, the
same cache layout and attention path) and prints the continuous /
batch-synchronous tok/s ratio; with ``--prefix-cache``, ``--spec-k`` or
``--early-exit`` it also re-runs the continuous workload with those off
and prints the two side by side:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --slots 8 --prompt-len 512 --requests 16 --kv paged \
        --attn-impl cuda --prefill chunked --chunk-tokens 128 \
        --early-exit --exit-threshold 0.5 --compare

``--stream`` serves through the asyncio front-end
(``serve.frontend.StreamingFrontend``) over the SLO scheduler
(``serve.slo``): every ``--hi-every``-th request is interactive, the rest
batch, segments are capped at ``--segment-steps`` iterations, at most
``--max-inflight`` requests are open, and under overload batch residents
are preempted; the report gives per-class p50/p99 TTFT and ITL in steps
and wall time.

``--disagg`` serves through prefill/decode disaggregation
(``serve.disagg.DisaggScheduler``): a prefill tier of ``--prefill-slots``
slots (0: ``--slots``) chunk-prefills the prompts, each finished prompt's
KV blocks are copied on a side stream into a fresh buffer and spliced
into the decode tier of ``--slots`` slots one round later. It implies
``--kv paged --prefill chunked``; in one process both tiers share the one
card (and its weights), as the JAX package's tiers share one device
without a mesh. The model drafter (``--spec-drafter model``) is refused:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --slots 8 --prompt-len 512 --requests 16 --attn-impl cuda \
        --chunk-tokens 128 --disagg --prefill-slots 2

On a job of several ranks (torchrun, or ``launch.distributed``) the
tiers live on disjoint slices: the leading ``--prefill-devices`` ranks
(half by default) hold the prefill tier, the rest the decode tier, each
tier's pool placed on its slice's mesh (``DecodeScheduler(rules=,
mesh=)``), and each finished prompt's blocks go from the prefill rank
that holds the row to the decode slice in a broadcast; every rank runs
the router alike and admits on the first rank's clock, and rank 0
prints the report, which names the split and the transfer path. On
gloo CPU ranks (no network: a ``FileStore``):

    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 8 \
        --device cpu repro_torch.launch.serve --arch smollm-135m --smoke \
        --slots 4 --prompt-len 16 --requests 8 --kv-block 4 --disagg \
        --prefill-devices 4 --device cpu

``--prefill oneshot`` (the default) admits prompts through one prefill
per admission round; a pure-SSM model and the hybrid (``--arch
zamba2-1.2b``: mamba2 layers under one shared attention block, whose
prompt K/V lands in one cache layer per application of the block) take
only this mode. Every prompt has exactly ``--prompt-len`` tokens, which
a pure-SSM, hybrid or MoE model requires (``--arch qwen2-moe-a2.7b``,
``--arch dbrx-132b --smoke``: dbrx at full width does not fit one
card). ``--arch internvl2-1b`` serves without patch embeddings
(``prefix_len`` 0), as the JAX package's launcher does. The selective scan's path
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
from repro_torch.dist import sharding as sh
from repro_torch.launch import distributed
from repro_torch.serve import disagg as disagg_lib
from repro_torch.serve import engine
from repro_torch.serve import sampling as sampling_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib


def build_workload(args, rng):
    """[(arrival_s, max_new)] sorted by arrival: the ``--trace`` CSV's
    lines, or Poisson arrivals alternating short/long ``max_new``."""
    if args.trace:
        rows = []
        with open(args.trace) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, m = line.split(",")
                rows.append((float(t), int(m)))
        return sorted(rows)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                         size=args.requests))
    return [(float(arrivals[i]),
             args.max_new_short if i % 2 == 0 else args.max_new_long)
            for i in range(args.requests)]


def pctl(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def make_prompts(args, cfg, n):
    """{request index: (1, prompt_len) prompt}, drawn from
    ``--prompt-pool`` distinct prompts (0: all distinct)."""
    rng = np.random.default_rng(args.seed)
    pool_n = args.prompt_pool or n
    pool = [rng.integers(2, cfg.vocab, (1, args.prompt_len)).astype(
        np.int32) for _ in range(pool_n)]
    return {i: pool[i % pool_n] for i in range(n)}


class _RunSteps:
    """The scheduler's loop iterations over a whole open-loop run: its
    run count, plus the counts it had when a submission to a drained
    pool restarted it."""

    def __init__(self, sched):
        self.sched, self.base = sched, 0

    def submit(self, *args, **kw):
        """``sched.submit``, keeping the count across a restart."""
        before = self.sched.total_steps
        rid = self.sched.submit(*args, **kw)
        if self.sched.total_steps < before:
            self.base += before
        return rid

    def __call__(self) -> int:
        return self.base + self.sched.total_steps


class TokenClock:
    """When each request's tokens reached the host, on two clocks: wall
    seconds and the scheduler's loop iterations. TTFT runs from arrival
    to the harvest that brought the first token; a burst of j tokens
    after a gap g counts j inter-token gaps of g / j (as the SLO layer
    does)."""

    def __init__(self):
        self.arrival, self.count, self.last = {}, {}, {}
        self.ttft, self.ttft_steps = {}, {}
        self.itl, self.itl_steps = [], []

    def arrive(self, rid, t, step=0):
        self.arrival[rid], self.count[rid] = (t, step), 0

    def observe(self, sched, finished, t, step=None):
        """Record the tokens that reached the host by wall time ``t`` and
        loop iteration ``step`` (default: the scheduler's run count): the
        resident requests' (the harvest's mirror) and the finished."""
        step = sched.total_steps if step is None else step
        seen = {rid: len(toks) for rid, toks in sched.resident().items()}
        seen.update({f.request_id: f.length for f in finished})
        for rid, n in seen.items():
            prev = self.count.get(rid, 0)
            if n <= prev or rid not in self.arrival:
                continue
            if prev == 0:
                self.ttft[rid] = t - self.arrival[rid][0]
                self.ttft_steps[rid] = step - self.arrival[rid][1]
            else:
                j = n - prev
                self.itl += [(t - self.last[rid][0]) / j] * j
                self.itl_steps += [(step - self.last[rid][1]) / j] * j
            self.count[rid], self.last[rid] = n, (t, step)

    def summary(self):
        out = {}
        for name, xs in (("ttft", list(self.ttft.values())),
                         ("ttft_steps", list(self.ttft_steps.values())),
                         ("itl", self.itl), ("itl_steps", self.itl_steps)):
            unit = "" if name.endswith("steps") else "_s"
            out[f"{name}_p50{unit}"] = pctl(xs, 50)
            out[f"{name}_p99{unit}"] = pctl(xs, 99)
        return out


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
        draft_cfg=draft_cfg, prefix_cache=args.prefix_cache)
    run = serve_arrivals(args, cfg, sched, workload)
    sched.close()
    return {**run, "occupancy": sched.occupancy, "steps": sched.total_steps,
            "attn_impl": sched.attn_impl,
            "prefill_impl": sched.prefill_impl,
            "loop_impl": sched.loop_impl, "segments": sched.segments,
            "host_reads": sched.host_reads,
            "graph_replays": sched.graph_replays,
            "spec_windows": sched.spec_windows,
            "accepted_tokens": sched.accepted_tokens,
            "drafted_tokens": sched.drafted_tokens,
            "accept_rate": sched.accept_rate,
            "mean_accept_len": sched.mean_accept_len,
            "prefix_hit_blocks": sched.prefix_hit_blocks,
            "prefix_evictions": sched.prefix_evictions,
            "peak_resident": sched.peak_resident,
            "mean_depth": sched.mean_depth, "depth_impl": sched.depth_impl}


def serve_arrivals(args, cfg, sched, workload):
    """The open-loop arrival loop over a scheduler (a ``DecodeScheduler``
    or a ``DisaggScheduler``): a warm-up request outside the timed window
    (it loads the kernels and the math libraries on the device; a prompt
    of none of the requests', so that it warms no prefix-cache entry of
    theirs), then each request submitted at its arrival and the
    scheduler stepped until all have finished. Returns wall and busy
    seconds, tokens, tok/s over busy time, latency p50/p99, the streams,
    each request's mean depth and ``TokenClock.summary()``. Tokens are
    counted from the streams collected here, and the clock's step marks
    from a count kept here: a submission to a drained pool restarts the
    scheduler's run counters (``reset_stats``), which would otherwise
    drop the tokens before the drain and send the marks backwards."""
    prompts = make_prompts(args, cfg, len(workload))
    agree = getattr(sched, "agree", lambda v: v)
    sched.submit(np.full((1, args.prompt_len), 2, np.int32), max_new=2,
                 request_id=-1)
    sched.run_until_drained()
    _sync(sched.device)
    sched.reset_stats()
    arrival_wall, finish_wall = {}, {}
    clock, streams, req_depth = TokenClock(), {}, {}
    t0 = time.perf_counter()
    next_req = 0
    idle_s = 0.0          # open-loop arrival gaps: excluded from tok/s
    steps = _RunSteps(sched)
    while len(finish_wall) < len(workload):
        # a fleet's ranks admit alike: on its first rank's clock
        now = agree(time.perf_counter() - t0)
        while next_req < len(workload) and workload[next_req][0] <= now:
            rid = steps.submit(prompts[next_req],
                               max_new=workload[next_req][1],
                               request_id=next_req)
            arrival_wall[rid] = workload[next_req][0]
            clock.arrive(rid, workload[next_req][0], steps())
            next_req += 1
        if sched.pending == 0:
            if next_req < len(workload):
                gap = max(0.0, workload[next_req][0] - now)
                time.sleep(gap)
                idle_s += gap
            continue
        finished = sched.step(expect_arrivals=next_req < len(workload))
        now = agree(time.perf_counter() - t0)
        clock.observe(sched, finished, now, steps())
        for f in finished:
            finish_wall[f.request_id] = now
            streams[f.request_id] = f.tokens
            req_depth[f.request_id] = f.mean_depth
    _sync(sched.device)
    wall = time.perf_counter() - t0
    busy = max(wall - idle_s, 1e-9)
    lat = [finish_wall[r] - arrival_wall[r] for r in finish_wall]
    toks = sum(len(s) for s in streams.values())
    return {"wall_s": wall, "busy_s": busy, "tok_s": toks / busy,
            "p50_s": pctl(lat, 50), "p99_s": pctl(lat, 99), "tokens": toks,
            "streams": streams, "req_depth": req_depth, **clock.summary()}


def run_disagg(args, cfg, params, workload):
    """The open-loop arrivals (``serve_arrivals``) through the two-tier
    ``DisaggScheduler``: in one process both tiers on the one device; on
    a job of several ranks the leading ``--prefill-devices`` ranks (half
    by default) hold the prefill tier and the rest the decode tier
    (``sharding.carve_slices``)."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    meshes = {}
    if world > 1:
        pf, de = sh.carve_slices(args.prefill_devices or world // 2)
        kind = params["embed"].device.type
        meshes = {"prefill_mesh": sh.slice_mesh(pf, device_type=kind),
                  "decode_mesh": sh.slice_mesh(de, device_type=kind)}
    elif args.prefill_devices > 1:
        raise SystemExit(
            f"--prefill-devices {args.prefill_devices} carves that many of "
            f"the job's ranks into the prefill tier; this job has one "
            f"rank: run it under torchrun or launch.distributed --ranks M "
            f"with M > {args.prefill_devices}")
    if args.spec_k and args.spec_drafter == "model":
        raise SystemExit("--disagg composes with the ngram drafter only (a "
                         "draft model would need its own cache shipped "
                         "between the tiers)")
    spec, _, _ = speculation(args)
    sched = disagg_lib.DisaggScheduler(
        params, cfg, n_prefill_slots=args.prefill_slots or args.slots,
        n_decode_slots=args.slots, prompt_len=args.prompt_len,
        max_new_cap=max(m for _, m in workload), eos_id=args.eos_id,
        sampling=sampling_lib.SamplingParams(temperature=args.temperature,
                                             top_k=args.top_k),
        seed=args.seed, kv_block=args.kv_block,
        decode_kv_blocks=args.kv_blocks, chunk_tokens=args.chunk_tokens,
        prefix_cache=args.prefix_cache, speculative=spec,
        segment_steps=args.segment_steps, **meshes)
    run = serve_arrivals(args, cfg, sched, workload)
    out = {**run, "steps": sched.total_steps,
           "prefill_devices": (sched.prefill_mesh.size() if meshes else 1),
           "decode_devices": (sched.decode_mesh.size() if meshes else 1),
           "prefill_steps": sched.prefill_steps,
           "attn_impl": sched.attn_impl,
           "prefill_impl": sched.prefill_impl,
           "loop_impl": sched.loop_impl,
           "transfer_impl": sched.transfer_impl,
           "transfers": sched.transfers,
           "transfer_bytes": sched.transfer_bytes,
           "preemptions": sched.preemptions,
           "replay_mismatches": sched.replay_mismatches,
           "host_reads": (sched._tier("prefill", "host_reads",
                                      "pf_host_reads"),
                          sched._tier("decode", "host_reads",
                                      "de_host_reads")),
           "segments": (sched._tier("prefill", "segments", "pf_segments"),
                        sched._tier("decode", "segments", "de_segments"))}
    sched.close()
    return out


def run_batch_sync(args, cfg, params, workload):
    """The batch-synchronous baseline: the workload's requests in
    batches of ``--slots``, back to back, through
    ``engine.generate_batch_sync`` with the same prompts, cache layout
    and attention path as the continuous run, each batch generating to
    its longest ``max_new`` (the last batch padded with copies of its
    last request). A row's tokens count up to its EOS or its own
    ``max_new``. Offline: no arrival gating. The paged pool is sized
    dense-equivalent (``--kv-blocks`` is a scheduler capacity knob)."""
    prompts = make_prompts(args, cfg, len(workload))
    dev = params["embed"].device

    def batch(idx):
        return torch.from_numpy(np.concatenate([prompts[i] for i in idx])
                                ).to(dev)

    def gen(idx, max_new):
        return engine.generate_batch_sync(
            params, cfg, batch(idx), max_new=max_new, eos_id=args.eos_id,
            kv_impl=args.kv, kv_block=args.kv_block)

    batches = [list(range(i, min(i + args.slots, len(workload))))
               for i in range(0, len(workload), args.slots)]
    with torch.no_grad():
        gen([0] * args.slots, 2)     # warm-up: kernels, math libraries
        _sync(dev)
        toks, res = 0, None
        t0 = time.perf_counter()
        for b in batches:
            cap = max(workload[i][1] for i in b)
            res = gen(b + [b[-1]] * (args.slots - len(b)), cap)
            lengths = res.lengths.tolist()
            toks += sum(min(lengths[j], workload[i][1])
                        for j, i in enumerate(b))
        _sync(dev)
        wall = time.perf_counter() - t0
    return {"wall_s": wall, "tok_s": toks / wall, "tokens": toks,
            "attn_impl": res.attn_impl}


def run_stream(args, cfg, params, workload):
    """The streaming front-end over the SLO scheduler: request i arrives
    at its workload time and is interactive when ``--hi-every`` divides
    i, batch otherwise. Returns ``SLOScheduler.json_summary()`` with the
    wall time, the tokens delivered and, per request, its tokens, its
    last event and its ``preempted`` events."""
    import asyncio

    from repro_torch.serve import frontend as fe
    from repro_torch.serve import slo as slo_lib

    cap = max(m for _, m in workload)
    sched = sched_lib.DecodeScheduler(
        params, cfg, n_slots=args.slots, prompt_len=args.prompt_len,
        max_new_cap=cap, eos_id=args.eos_id, kv=args.kv,
        kv_block=args.kv_block, kv_blocks=args.kv_blocks,
        prefill=args.prefill, chunk_tokens=args.chunk_tokens,
        sampling=sampling_lib.SamplingParams(temperature=args.temperature,
                                             top_k=args.top_k),
        seed=args.seed, prefix_cache=args.prefix_cache)
    sched.warmup()
    slo = slo_lib.SLOScheduler(sched, segment_steps=args.segment_steps)
    front = fe.StreamingFrontend(slo, max_inflight=args.max_inflight)
    prompts = make_prompts(args, cfg, len(workload))
    streams = {}

    async def client(i, arrival, max_new):
        await asyncio.sleep(arrival)
        klass = ("interactive" if args.hi_every and i % args.hi_every == 0
                 else "batch")
        rec = streams[i] = {"class": klass, "tokens": [], "last": None,
                            "preempted": 0}
        async for ev in front.stream(prompts[i], max_new=max_new,
                                     slo_class=klass, request_id=i):
            rec["last"] = ev["event"]
            if ev["event"] == "token":
                rec["tokens"].extend(ev["tokens"])
            elif ev["event"] == "preempted":
                rec["preempted"] += 1

    async def drive():
        await asyncio.gather(*[client(i, a, m)
                               for i, (a, m) in enumerate(workload)])

    t0 = time.perf_counter()
    asyncio.run(drive())
    _sync(sched.device)
    summary = slo.json_summary()
    summary.update(wall_s=time.perf_counter() - t0, streams=streams,
                   tokens=sum(len(r["tokens"]) for r in streams.values()),
                   segments=sched.segments,
                   prefix_hit_blocks=sched.prefix_hit_blocks,
                   loop_impl=sched.loop_impl)
    sched.close()
    return summary


def print_stream(s):
    print(f"[serve] stream ({s['loop_impl']}): {s['tokens']} tokens in "
          f"{s['wall_s']:.2f}s | {s['preemptions']} preemptions, "
          f"{s['replay_mismatches']} replay mismatches, {s['completed']} "
          f"completed ({s['total_steps']} device steps, segment="
          f"{s['segment_steps']}) | {s['rounds']} rounds, "
          f"{s['host_reads']} host reads, {s['prefix_hit_blocks']} prefix "
          f"hit blocks")
    for name, c in s["classes"].items():
        tw, iw = c["ttft_wall_s"], c["itl_wall_s"]
        ts, is_ = c["ttft_steps"], c["itl_steps"]
        print(f"[serve]   {name} (prio {c['priority']}): {c['completed']} "
              f"done, {c['preempted_times']} preempted | TTFT p50 "
              f"{ts['p50'] or 0:.0f}/p99 {ts['p99'] or 0:.0f} steps "
              f"({(tw['p50'] or 0) * 1e3:.0f}/{(tw['p99'] or 0) * 1e3:.0f}"
              f"ms) | ITL p50 {is_['p50'] or 0:.1f}/p99 "
              f"{is_['p99'] or 0:.1f} steps ({(iw['p50'] or 0) * 1e3:.1f}/"
              f"{(iw['p99'] or 0) * 1e3:.1f}ms)")


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
    ap.add_argument("--trace", default=None,
                    help="CSV of arrival_s,max_new lines (default: "
                         "Poisson arrivals)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt blocks between requests "
                         "(needs --prefill chunked --kv paged): a repeated "
                         "prompt maps the cached blocks and prefills from "
                         "its first uncached block; greedy streams are "
                         "unchanged")
    ap.add_argument("--prompt-pool", type=int, default=0,
                    help="draw the prompts from this many distinct ones "
                         "(0: all distinct): the traffic --prefix-cache "
                         "serves")
    ap.add_argument("--early-exit", action="store_true",
                    help="confidence-based early-exit decode: rows whose "
                         "top-1/top-2 logit margin clears "
                         "--exit-threshold stop running layers; skipped "
                         "layers' K/V is filled from the halting layer's "
                         "hidden state; threshold inf gives the "
                         "non-adaptive streams bit for bit")
    ap.add_argument("--exit-threshold", type=float, default=float("inf"),
                    help="early-exit logit-margin threshold (inf: never "
                         "exit early; smaller: shallower)")
    ap.add_argument("--exit-min-layers", type=int, default=1,
                    help="layers every token runs before the halt check "
                         "can fire")
    ap.add_argument("--mod-capacity", type=float, default=0.0,
                    help="mixture-of-depths: fraction of tokens each "
                         "routed layer processes in training; decode "
                         "routes by the per-token gate (0: off; adds "
                         "zero-initialised router params)")
    ap.add_argument("--mod-every", type=int, default=2,
                    help="route every Nth layer when --mod-capacity is set")
    ap.add_argument("--compare", action="store_true",
                    help="also run the batch-synchronous baseline and "
                         "print the continuous/batch-sync tok/s ratio; "
                         "with --prefix-cache, --spec-k or --early-exit, "
                         "also re-run the continuous workload with them "
                         "off and print both side by side")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the asyncio streaming front-end "
                         "over the SLO scheduler (priority classes, "
                         "preemption); reports per-class TTFT/ITL")
    ap.add_argument("--segment-steps", type=int, default=8,
                    help="--stream: iterations a segment at most (the "
                         "granularity of tokens and preemption)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="--stream: open requests at most (backpressure)")
    ap.add_argument("--hi-every", type=int, default=4,
                    help="--stream: every Nth request is interactive "
                         "(0: all batch)")
    ap.add_argument("--disagg", action="store_true",
                    help="prefill/decode disaggregation: a prefill tier "
                         "chunk-prefills prompts and ships their KV "
                         "blocks to a decode tier, both on the one card; "
                         "implies --kv paged --prefill chunked")
    ap.add_argument("--prefill-slots", type=int, default=0,
                    help="--disagg: the prefill tier's slots (0 = --slots)")
    ap.add_argument("--prefill-devices", type=int, default=0,
                    help="--disagg on a job of several ranks: the leading "
                         "ranks that hold the prefill tier (0: half); the "
                         "rest hold the decode tier")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.early_exit or args.mod_capacity:
        cfg = dataclasses.replace(
            cfg, early_exit=args.early_exit,
            exit_threshold=args.exit_threshold,
            exit_min_layers=args.exit_min_layers,
            mod_capacity=args.mod_capacity, mod_every=args.mod_every)
    if args.disagg:
        # a torchrun job's group (a no-op in one process, and under
        # launch.distributed, which has made it)
        distributed.init_distributed(
            device_type=torch.device(args.device).type)
    params = bridge.init_params(cfg, seed=0, device=args.device)
    workload = build_workload(args, np.random.default_rng(args.seed))
    if args.stream:
        s = run_stream(args, cfg, params, workload)
        print_stream(s)
        return s
    if args.disagg:
        d = run_disagg(args, cfg, params, workload)
        if torch.distributed.is_initialized() and \
                torch.distributed.get_rank() != 0:
            return d                   # rank 0 reports for the fleet
        where = (f"both tiers on one {args.device} device"
                 if d["transfer_impl"] in ("cuda-copy:side-stream",
                                           "torch-copy:cpu") else
                 f"prefill on {d['prefill_devices']} and decode on "
                 f"{d['decode_devices']} {args.device} ranks")
        print(f"[serve] disagg, {where} "
              f"(decode {d['attn_impl']}, prefill {d['prefill_impl']}, "
              f"transfer {d['transfer_impl']}, loop {d['loop_impl']}): "
              f"{d['tokens']} tokens, {d['wall_s']:.2f}s wall "
              f"({d['busy_s']:.2f}s busy) -> {d['tok_s']:.1f} tok/s | "
              f"latency p50 {d['p50_s'] * 1e3:.0f}ms "
              f"p99 {d['p99_s'] * 1e3:.0f}ms | {d['steps']} decode steps + "
              f"{d['prefill_steps']} prefill-tier steps | TTFT p99 "
              f"{d['ttft_p99_s'] * 1e3:.1f}ms, inter-token p50 "
              f"{d['itl_p50_s'] * 1e3:.2f}ms p99 "
              f"{d['itl_p99_s'] * 1e3:.2f}ms")
        print(f"[serve]   shipped {d['transfers']} KV shipments "
              f"({d['transfer_bytes'] / 1e6:.2f} MB) | "
              f"{d['preemptions']} preemptions, "
              f"{d['replay_mismatches']} replay mismatches | host reads "
              f"{d['host_reads'][0]} prefill tier ({d['segments'][0]} "
              f"segments), {d['host_reads'][1]} decode tier "
              f"({d['segments'][1]} segments)")
        return d
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
          f"{cont['graph_replays']} graph launches | TTFT p50 "
          f"{cont['ttft_p50_s'] * 1e3:.1f}ms p99 "
          f"{cont['ttft_p99_s'] * 1e3:.1f}ms, inter-token p50 "
          f"{cont['itl_p50_s'] * 1e3:.2f}ms p99 "
          f"{cont['itl_p99_s'] * 1e3:.2f}ms")
    if args.early_exit or args.mod_capacity:
        by_class = {}
        for rid, d in cont["req_depth"].items():
            by_class.setdefault(workload[rid][1], []).append(d)
        per = ", ".join(f"max_new={m}: {np.mean(ds):.2f}"
                        for m, ds in sorted(by_class.items()))
        print(f"[serve] adaptive depth (threshold={args.exit_threshold:g}"
              f", mod_capacity={args.mod_capacity:g}; layer loop "
              f"{cont['depth_impl']}): {cont['mean_depth']:.2f} mean "
              f"layers/token of {cfg.n_layers} | per class: {per}")
    if args.prefix_cache:
        print(f"[serve] prefix cache: {cont['prefix_hit_blocks']} blocks "
              f"served from the cache, {cont['prefix_evictions']} "
              f"evictions, peak resident {cont['peak_resident']}")
    if args.spec_k:
        print(f"[serve] speculative (k={args.spec_k}, {args.spec_drafter}): "
              f"{cont['accepted_tokens']}/{cont['drafted_tokens']} drafts "
              f"accepted (accept rate {cont['accept_rate'] * 100:.0f}%), "
              f"mean accept length {cont['mean_accept_len']:.2f}, "
              f"{cont['tok_s']:.1f} tok/s")
    if args.compare:
        compare(args, cfg, params, workload, cont)
    return cont


def compare(args, cfg, params, workload, cont):
    """``--compare``: the continuous run with its features off (when any
    of the prefix cache, speculation and early exit is on; the router
    params of mixture-of-depths serve both runs), then the
    batch-synchronous baseline and the continuous/batch-sync ratio.
    Adds ``off`` and ``batch_sync`` to ``cont``."""
    if args.prefix_cache or args.spec_k or args.early_exit:
        off = argparse.Namespace(**{**vars(args), "prefix_cache": False,
                                    "spec_k": 0, "early_exit": False})
        base = run_continuous(off, dataclasses.replace(
            cfg, early_exit=False), params, workload)
        same = sum(len(cont["streams"][r]) == len(base["streams"][r]) and
                   bool((cont["streams"][r] == base["streams"][r]).all())
                   for r in base["streams"])
        feats = "+".join(
            (["spec-k%d" % args.spec_k] if args.spec_k else [])
            + (["prefix-cache"] if args.prefix_cache else [])
            + (["early-exit@%g" % args.exit_threshold]
               if args.early_exit else []))
        print(f"[serve] {feats} vs off: tok/s {cont['tok_s']:.1f} | "
              f"{base['tok_s']:.1f}; device steps {cont['steps']} | "
              f"{base['steps']}; TTFT p99 {cont['ttft_p99_s'] * 1e3:.1f} | "
              f"{base['ttft_p99_s'] * 1e3:.1f}ms; peak resident "
              f"{cont['peak_resident']} | {base['peak_resident']}; mean "
              f"layers/token {cont['mean_depth']:.2f} | "
              f"{base['mean_depth']:.2f}; streams equal "
              f"{same}/{len(base['streams'])}")
        cont["off"] = base
    sync = run_batch_sync(args, cfg, params, workload)
    print(f"[serve] batch-sync ({sync['attn_impl']}; offline, no arrival "
          f"gating): {sync['tokens']} tokens in {sync['wall_s']:.2f}s -> "
          f"{sync['tok_s']:.1f} tok/s")
    # both rates are busy-time rates, so the ratio is arrival-free
    sync["ratio"] = cont["tok_s"] / max(sync["tok_s"], 1e-9)
    print(f"[serve] continuous/batch-sync busy tokens/s ratio: "
          f"{sync['ratio']:.2f}x")
    cont["batch_sync"] = sync


if __name__ == "__main__":
    main()
