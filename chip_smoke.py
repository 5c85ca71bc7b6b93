#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3, 6, 9 and 13 only

``--kernels-only`` runs the card and build phases and the phases that
check and time a kernel alone, all five kernels (the block-table
kernels with the chunk kernel's verify entry, the selective scan, the
LSTM cell, flash attention), and prints their records with launches 0: copied into a checkout of another
commit, it times that commit's kernels the same way. Every kernel's
time is taken twice over the same operand copies: as device time (the
calls captured once in a CUDA graph and replayed) and as eager calls
(the caller's time, the wrapper's host work included).

Phases, each printing its own lines:

1. the card: its name and power limit as ``nvidia-smi`` reports them;
   TF32 is switched off for matmuls and cuDNN;
2. the build: the five kernels and ``graph_loop.cu`` (the graph
   lowering's conditional nodes) compiled from
   ``src/repro_torch/kernels/csrc`` with ``nvcc``, one process each, all
   started together, with ptxas's register and shared memory report;
3. each block-table kernel against its plain PyTorch version on the
   card, at the llama3.2-1b, qwen2-7b, olmo-1b and smollm-135m attention
   geometries (G = 4, 7, 1, 3; hd = 64, 128), in bf16 and fp32, with
   blocks of 16 and 8, shuffled tables, ``-1`` entries, ragged lengths,
   a ``cur_len = 0`` row (exactly 0), cur_len on the decode kernel's
   partition edges and a chunk running past the table; the chunk
   kernel's ``flash_verify`` entry on speculative windows (W = 2, 5, 8,
   bf16 and fp32, blocks 16 and 8, q_off on the decode kernel's
   partition edges); then each kernel timed at the serving phase's
   shapes (llama3.2-1b, and qwen2-7b for hd 128; the verify entry at
   B = 8, W = 5, q_off 512-568) beside the plain version,
   ``scaled_dot_product_attention`` on the gathered dense layout (a
   yardstick the port never calls) and the bound;
4. serving llama3.2-1b at full width (random weights from a seed, bf16)
   through the continuous-batching scheduler with the paged cache,
   chunked prefill and both kernels, once with the segment as a
   captured CUDA graph (WHILE and IF nodes; ``loop_impl``
   ``cuda-graph:while``) and once with the host-read segment, in turns
   (graph, host, host, graph): every request must finish, both kernels
   must have launched, the gather path must not have run; a graph run
   must make one host read per segment and none in a body; each
   kernel's launches (counted on the device inside the graph) must equal
   the host-read run's (counted in Python at each eager launch) and its
   count at capture times the device's runs of its branch; tok/s,
   segments, host reads, the device idle at the per-segment read, host
   launches per iteration and each path's device-busy share from its own
   run (graph: CUDA events around the segments over the run's wall;
   host-read: a profiled run's kernel time over its wall) are printed,
   and how many bf16 streams the two paths share;
5. the same requests in fp32 through the kernel path in graph segments,
   in host-read segments, and the gather path: the greedy streams must
   be identical;
6. the selective-scan kernel against its plain version on the card at
   the falcon-mamba-7b chunk (B=8, Q=128, Di=8192, N=16), one row, an
   odd Q, the smoke width (N=8), one layer of a 512-token admission
   (Q=512) and Q=1 at a ragged Di, every case with a non-zero incoming
   state; one launch over 512 steps must equal four chained 128-step
   launches bit for bit; then timed at the serving chunk beside the
   plain version and the bound, and at the per-layer call (Q=512)
   beside the chunk chain the call site made before and its bound;
7. serving falcon-mamba-7b at full width and depth (random weights
   from a seed, bf16, ``scan_impl="cuda"``) through one-shot admission,
   graph segments against host-read ones in turns as in phase 4 (the
   admissions stay eager between segments): every request must finish
   and the kernel must have launched once per layer per admission; one
   admission's prefill is profiled for the kernel's device time and the
   copy kernels';
8. 8 of those requests in fp32 through the kernel's scan in graph
   segments, in host-read segments, and the plain blocked scan: the
   greedy streams must be identical;
9. the fused LSTM-cell kernel against its plain version on the card at
   B=512, D=H=512, one row, B=37 with H=48, and the NMT encoder and
   decoder shapes, in fp32 and bf16 with a non-zero incoming state; its
   refusal of operands that require grad; then timed at B=512, D=H=512
   fp32 beside the plain version, ``torch.lstm_cell`` (a yardstick the
   port never calls) and the bound;
10. ``dynamic_rnn`` inference through the kernel cell at B=512, D=H=512,
    S=1000 with ragged lengths in [500, 1000]: outputs and final state
    equal the unfused cell's, the kernel launches once per step up to
    max(lens), and the loop's predicate reads and the device idle at
    them are printed; then dynamic (counted, and with seq_lens) vs static
    forward time at B = 8, 32, 128, 512 (the paper's Fig. 14; printed,
    not a gate);
11. Table 1: training through the loop (gradients of ``mean(y**2)``
    through ``dynamic_rnn`` with the unfused cell) at B=512, D=H=512,
    S = 100 and 500 under the four save policies: every policy's
    gradients equal ``all``'s, and at S=500 the peak device memory above
    the weights is lower under ``offload`` and ``carry`` than under
    ``all``; time per loop iteration, peak memory and host bytes are
    printed;
12. the NMT example (``repro_torch.examples.dynamic_rnn_nmt``) trains
    250 steps on the card to a loss below 0.5;
13. the flash-attention kernel against its plain version on the card at
    the JAX kernel sweep's shapes (MHA, GQA 4:1 and 2:1, MQA; D = 16,
    32, 64, 128; S = 64-256), at D=8 (the smoke llama's head dim) and
    at the llama3.2-1b forward's (B=4, S=2048, H=32, KV=8, D=64), fp32
    and bf16, causal and not, and at the wgmma route's edges (S and T
    off multiples of 128, T != S both ways, one 128-row tile, D=128 at
    G=7, B > 1); its refusal of operands that require grad; then timed
    at the forward's shape beside the plain version,
    ``scaled_dot_product_attention`` (a yardstick the port never calls)
    and the bound, and at qwen2-7b's (B=4, S=2048, H=28, KV=4, D=128)
    beside SDPA;
14. ``model_zoo.forward`` and ``loss_fn`` of llama3.2-1b at full width
    (random weights from a seed, B=4, S=2048 tokens from ``SyntheticLM``)
    under ``no_grad`` with ``attn_impl="cuda"`` (the kernel launches
    once per layer) and ``"gather"`` (chunked attention, no launch), in
    bf16 and in fp32 compute on the same weights: the fp32 logits must
    agree within 1e-3; in bf16 each layer's kernel call must agree with
    the plain version on its own operands within the kernel's tolerance,
    and the logits must lie within ``FWD_BF16_TOL`` of the forward with
    mode ``full`` routed to the plain version, which a 1% attention error
    must not; greedy agreement and ms per forward are printed;
15. training: ``launch.train.main`` at llama3.2-1b full width (fp32
    masters, bf16 compute, ``remat="full"``, B=4, S=2048) for a few
    steps into a temporary checkpoint directory: the loss must be
    finite and fall, the checkpoint must restore bit for bit and a
    second launch must resume from it; one step under
    ``layer_loop="paper_while"`` with ``save_policy="offload"`` must
    give ``scan``'s loss; one step at B=1 under each of ``remat="full"``,
    ``"attn_out"`` and ``"none"`` must give one loss, and the memory
    held for the backward after the forward must rise in that order;
    and a step under ``attn_impl="cuda"`` must stop at the kernel's
    refusal;
16. (run after phase 3) the paper's §6.1 loop: 200 iterations of
    ``tanh(x @ w)``, x (8, 128), w (128, 128), fp32, as a Python loop,
    as ``core.while_loop`` with the host-read predicate and as
    ``core.while_loop(impl="graph")`` (capture timed apart from
    replay): iterations per second each way; the three must agree;
17. (run after phase 5) speculative serving of llama3.2-1b at full width
    (bf16, k = 4, n-gram drafter, the chunked paged pool of phase 4):
    the 16 serving requests, and a variant whose prompts each tile one
    random 32-token segment, each through graph and host-read segments
    in turns as in phase 4 and beside the non-speculative graph run of
    the same requests: every request must finish, ``flash_verify`` must
    have launched (counted on the device in the graph) and neither
    ``paged_attention`` nor the gather path; tok/s, accept rate, mean
    accept length and the device's share of the wall in segments are
    printed;
18. the first 8 of both request sets in fp32: speculative graph
    segments, speculative host-read segments and non-speculative graph
    segments must give identical greedy streams; and the model drafter
    (smollm-135m smoke drafting for the smoke llama3.2-1b at head dim
    64, both vocab 512) likewise against its host-read run and the
    non-speculative run;
19. sampled decoding at full width (bf16): temperature 0.8 with top-k 0
    and 50, and speculation at temperature 0.8, each in graph segments
    with 8 slots, host-read segments with 8 and graph segments with 4:
    the streams must be identical (the same seed); each configuration's
    device ms an iteration (CUDA events around the graph segments over
    the loop's iterations) is printed against greedy decoding's.

The llama3.2-1b weights are freed before falcon-mamba's are made, and
falcon-mamba's before the LSTM phases, and each of the last three
phases frees what it made. Then
one JSON line of kernel records and, last, the device line. Any
failed check raises, so the script exits non-zero and prints no result;
it also exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
SMS = 132                          # H100 SXM streaming multiprocessors
SFU_PER_CLOCK = 16                 # ex2 results per clock per SM (sm_90)
TOL = {"bfloat16": 1.6e-2,  # two bf16 ulps at magnitude 1: the output
       #                     is rounded to bf16 on both sides
       "float32": 1e-4}     # fp32 sums in another order over up to
#                             2048 positions
GEOMETRIES = (("llama3.2-1b", 32, 8, 64), ("qwen2-7b", 28, 4, 128),
              ("olmo-1b", 16, 16, 128), ("smollm-135m", 9, 3, 64))
# the TPU kernel (or kernel entry) that each record of the kernels line
# replaces
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:51",
    "flash_prefill": "src/repro/kernels/flash_prefill/kernel.py:50",
    "flash_verify": "src/repro/kernels/flash_prefill/ops.py:21",
    "selective_scan": "src/repro/kernels/selective_scan/kernel.py:27",
    "lstm_cell": "src/repro/kernels/lstm_cell/kernel.py:25",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:29"}
# records whose kernel lives in another record's source: the verify entry
# launches the chunk kernel
SOURCE = {"flash_verify": "flash_prefill"}
SCAN_TOL = 1e-4     # fp32: N-term sums in another order, fused
#                     multiply-adds, states of magnitude up to ~10
SCAN_CHUNK = 128    # falcon-mamba-7b's cfg.ssm.chunk: the TPU kernel's chunk
SCAN_LAYER = 512    # one layer's call in a one-shot admission of 512 tokens
LSTM_TOL = {"float32": 1e-5,    # K <= 1024 fp32 products summed in
            #                     another order
            "bfloat16": 1.6e-2}  # c', h' rounded to bf16 on both sides
RNN_TOL = 1e-4      # fp32: per-step differences of ~1e-6 carried through
#                     up to 1000 steps of the recurrence
FA_TOL = {  # (rtol, atol) of |kernel - plain| <= atol + rtol |plain|
    "float32": (1e-5, 1e-5),     # the same fp32 math summed in another order
    "bfloat16": (2**-7, 2**-8)}  # rtol: one bf16 ulp, as the output is
#                                  rounded to bf16 on both sides; atol: the
#                                  tensor-core route rounds p to bf16 for
#                                  PV, at most 2^-8 of sum_j p_j |v_j|, and
#                                  |v| is of order 1 (the H100 readings
#                                  need at most 2.8e-3)
FA_SWEEP = ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 64, 6, 3, 128),
            (2, 128, 2, 1, 16),          # (B, S, H, KV, D): the JAX sweep,
            (2, 128, 8, 2, 8))           # and the smoke llama's head dim
FA_FORWARD = (4, 2048, 32, 8, 64)        # the llama3.2-1b forward's shape
FA_QWEN = (4, 2048, 28, 4, 128)          # qwen2-7b's geometry, timed beside
FA_EDGES = (  # (B, S, H, KV, D, T): the wgmma route's edges (D = 64, 128):
    (2, 200, 8, 2, 64, 200),     # S, T off multiples of 128, B > 1 (TMA's
    (2, 130, 8, 2, 64, 300),     # zero fill past T in each batch row); T > S
    (3, 300, 28, 4, 128, 130),   # T < S, D = 128 at G = 7
    (1, 128, 4, 1, 64, 128))     # a single 128-row tile
LOGIT_TOL = 1e-3   # fp32 compute: 16 layers of fp32 sums in another order
FWD_BF16_TOL = {"max": 0.125, "mean": 1.5e-2}  # bf16 logits against the
#   forward routed through the kernel's plain version: 16 random bf16 layers
#   carry any rounding difference to a mean of about 1.2e-2 (the chunked
#   path, which rounds elsewhere, reads max 9.4e-2, mean 1.2e-2 on the H100);
#   a 1% error on every layer's attention output reads 1.6e-1 and 1.9e-2,
#   and the script checks that it falls outside. The kernel itself is held
#   to FA_TOL on each layer's own operands.
FWD_PERTURB = 1.01  # a 1% error on every layer's attention output
TRAIN_STEPS = 16                 # enough for the loss to fall reliably
STEP_LOSS_RTOL = 1e-6            # paper_while+offload vs scan: the same ops
SPEC_K = 4          # drafted tokens a verify window (the JAX default)
VERIFY_W = SPEC_K + 1


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_record(name, err, times, plain_ms, b_ms, b_by):
    """A kernel's entry of the ``kernels`` line; ``main`` fills in its
    launches from the main path's run. ``times`` is ``call_times``'s:
    ``ms`` and ``library_ms`` are device times (CUDA-graph replays) for
    every kernel, ``eager_ms`` and ``library_eager_ms`` the same calls
    made eagerly (the caller's time, the wrapper's host work included);
    ``plain_ms`` is the plain version's eager time."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{SOURCE.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": times["ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": times["library_ms"],
            "eager_ms": times["eager_ms"],
            "library_eager_ms": times["library_eager_ms"]}


# ------------------------------------------------------------------ cases

def _table(gen, rows_need, bpr, n_blocks, device):
    """Shuffled physical ids; entries past each row's need are -1."""
    import torch
    ids = torch.randperm(n_blocks, generator=gen)[:len(rows_need) * bpr]
    table = ids.reshape(len(rows_need), bpr).to(torch.int32)
    cols = torch.arange(bpr)[None, :]
    need = torch.tensor(rows_need)[:, None]
    return torch.where(cols < need, table, -1).to(device)


def make_case(kind, seed, H, KV, hd, dtype, lens, block=16, max_len=2048,
              C=128, device="cuda"):
    """Operands of one kernel call. ``lens`` are cur_len (decode) or
    q_off (prefill) per row; the pool holds every row's blocks plus 3
    unused ones."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    B = len(lens)
    bpr = -(-max_len // block)
    n_blocks = B * bpr + 3

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device, dtype)

    kp, vp = rand(n_blocks, block, KV, hd), rand(n_blocks, block, KV, hd)
    if kind == "decode":
        q = rand(B, 1, H, hd)
        need = [-(-n // block) for n in lens]
    else:
        q = rand(B, C, H, hd)
        need = [-(-min(n + C, bpr * block) // block) for n in lens]
    table = _table(gen, need, bpr, n_blocks, device)
    pos = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, kp, vp, table, pos


def bound(kind, q, kp, vp, table, pos):
    """(bound_ms, bound_by): the larger of the bytes that must move
    (each input read once, the output written once, K/V only for the
    positions this run's rows see) over HBM bandwidth, and the FLOPs
    (QK and PV) over the peak rate for the dtype."""
    B, C, H, hd = q.shape
    KV = kp.shape[2]
    isz = q.element_size()
    width = table.shape[1] * kp.shape[1]
    lens = pos.tolist()
    if kind == "decode":
        kv_pos = sum(min(n, width) for n in lens)
        flops = 4 * H * hd * kv_pos
    else:
        kv_pos = sum(min(n + C, width) for n in lens)
        flops = 4 * H * hd * sum(min(n + c + 1, width)
                                 for n in lens for c in range(C))
    nbytes = (2 * q.numel() * isz + 2 * kv_pos * KV * hd * isz
              + table.numel() * 4 + pos.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, n_args, iters=30):
    """Mean ms per call over ``iters`` calls cycling through ``n_args``
    operand copies (more bytes than the 50 MB L2, so each call finds
    its K/V cold, as a layer of the serving loop does)."""
    import torch
    for i in range(3):
        fn(i % n_args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n_args, reps=10):
    """Device ms per call, with no host work between launches: the
    ``n_args`` calls captured once in a CUDA graph (after a warm-up
    outside it), the graph replayed ``reps`` times between two events.
    The calls cycle through operand copies as in ``time_ms``."""
    import torch
    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_args):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_args)


def call_times(kernel_call, n_args, library_call=None, iters=30):
    """The kernel's and, where there is one, the library call's time per
    call over ``n_args`` operand copies: device time (``graph_ms``) and
    eager (``time_ms``), as ``kernel_record`` takes them."""
    times = {"ms": graph_ms(kernel_call, n_args),
             "eager_ms": time_ms(kernel_call, n_args, iters),
             "library_ms": None, "library_eager_ms": None}
    if library_call is not None:
        times["library_ms"] = graph_ms(library_call, n_args)
        times["library_eager_ms"] = time_ms(library_call, n_args, iters)
    return times


def fmt_times(times, library="sdpa"):
    """``call_times``'s readings for a log line."""
    text = (f"device time (CUDA graph replay): kernel {times['ms']:.4f} ms"
            + (f", {library} {times['library_ms']:.4f} ms"
               if times["library_ms"] is not None else "")
            + f"; eager calls: kernel {times['eager_ms']:.4f} ms")
    if times["library_eager_ms"] is not None:
        text += f", {library} {times['library_eager_ms']:.4f} ms"
    return text


def sdpa_operands(kind, q, kp, vp, table, pos):
    """Dense layout for the library yardstick: K/V gathered through the
    table and repeated to H heads, with the boolean visibility mask."""
    import torch
    from repro_torch.kernels.paged_attention.ref import gather_kv
    B, C, H, hd = q.shape
    kg, vg = gather_kv(kp, vp, table)
    G = H // kp.shape[2]
    kd = kg.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vd = vg.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    T = kd.shape[2]
    t = torch.arange(T, device=q.device)
    if kind == "decode":
        mask = (t[None, :] < pos[:, None])[:, None, None, :]
    else:
        qpos = pos[:, None] + torch.arange(C, device=q.device)[None]
        mask = (t[None, None, :] <= qpos[:, :, None])[:, None]
    return q.transpose(1, 2).contiguous(), kd, vd, mask


# ----------------------------------------------------------------- phases

def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    return smi


def demangle(names):
    """``names`` through the CUDA toolkit's ``cu++filt`` (or binutils'
    ``c++filt``) without parameter lists; unchanged where neither is
    installed."""
    from repro_torch import kernels
    tools = (Path(kernels._nvcc()).with_name("cu++filt"),
             shutil.which("c++filt"))
    tool = next((str(t) for t in tools if t and Path(t).exists()), None)
    if tool is None or not names:
        return names
    out = subprocess.run([tool, "-p"], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return [ln.replace("(anonymous namespace)::", "")
            for ln in out.splitlines()]


def ptxas_report(out):
    """One line per kernel instance from ``nvcc -Xptxas -v``: its
    registers, shared memory and spills."""
    rows, name, spill = [], "?", ""
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            rows.append((name, ln.split(":", 1)[1].strip(), spill))
    names = demangle([name for name, _, _ in rows])
    return [f"{name}: {used}; {spill}"
            for name, (_, used, spill) in zip(names, rows)]


def phase_build():
    from repro_torch import kernels
    t0 = time.perf_counter()
    report = kernels.build_all()
    log(f"[build] {len(report)} sources built in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc, "
        f"{kernels.ARCH_TAG})")
    for name, (secs, out) in report.items():
        log(f"[build] {name}: {secs:.1f} s")
        for ln in ptxas_report(out):
            log(f"[build]   {ln}")
    for name in kernels.SOURCES:
        kernels.library(name)


def time_block_table(kind, name, geom, fns):
    """One block-table kernel at the serving phase's shapes for the
    attention geometry ``geom``: 8 slots, 512-token prompts, block 16,
    37 blocks per row; decode rows mid-generation, prefill rows at the
    four chunk offsets of a 512-token prompt with 128-token chunks,
    verify windows (W = 5, speculation's k = 4) at q_off 512-568. Times
    the kernel and SDPA on the gathered dense layout over 8 operand
    copies (``call_times``: device and eager), and the plain version
    eagerly. Returns its record (launches 0)."""
    import torch
    arch, H, KV, hd = geom
    main_lens = {"decode": [513 + 8 * i for i in range(8)],
                 "prefill": [0, 128, 256, 384] * 2,
                 "verify": [512 + 8 * i for i in range(8)]}
    kern, plain = fns[kind]
    C = VERIFY_W if kind == "verify" else 128
    shape = "decode" if kind == "decode" else "prefill"
    copies = [make_case(shape, 100 + i, H, KV, hd, torch.bfloat16,
                        main_lens[kind], max_len=577, C=C)
              for i in range(8)]
    out = kern(*copies[0])
    ref = plain(*copies[0])
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(),
                          atol=TOL["bfloat16"], rtol=TOL["bfloat16"]):
        raise AssertionError(f"{name} disagrees at serving shapes ({arch})")
    dense = [sdpa_operands(shape, *c) for c in copies]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel_call(i):
        return kern(*copies[i])

    def sdpa_call(i):
        return sdpa(dense[i][0], dense[i][1], dense[i][2],
                    attn_mask=dense[i][3])

    times = call_times(kernel_call, len(copies), sdpa_call)
    plain_ms = time_ms(lambda i: plain(*copies[i]), len(copies), iters=10)
    b_ms, b_by = bound(shape, *copies[0])
    log(f"[kernels] time {name} at serving shapes ({arch}) "
        f"q {tuple(copies[0][0].shape)} bf16, {fmt_times(times)}, plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); device "
        f"kernel/sdpa {times['ms'] / times['library_ms']:.2f}, "
        f"kernel/bound {times['ms'] / b_ms:.1f}; max |kernel - plain| "
        f"{err:.3e}")
    return kernel_record(name, err, times, plain_ms, b_ms, b_by)


def check_verify(fns):
    """The chunk kernel's verify entry against its plain version
    (``flash_prefill_ref``) on speculative windows W = 2, 5, 8 at
    llama3.2-1b's geometry, bf16 and fp32, blocks of 16 and 8, q_off at
    0, on the decode kernel's partition edges (63, 64, 65), at 127, 128,
    500 and at the table's end."""
    import torch
    kern, plain = fns["verify"]
    lens = [0, 1, 63, 64, 65, 127, 128, 500, 2048 - 8]
    seed = 500
    for W in (2, 5, 8):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for block in (16, 8):
                seed += 1
                args = make_case("prefill", seed, 32, 8, 64, dtype, lens,
                                 block=block, C=W)
                out = kern(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                err = (out.float() - ref.float()).abs().max().item()
                ok = torch.allclose(out.float(), ref.float(),
                                    atol=TOL[dname], rtol=TOL[dname])
                log(f"[kernels] check verify  W={W} H=32 KV=8 hd=64 "
                    f"block={block:2d} {dname:8s}: max |kernel - plain| = "
                    f"{err:.3e} (tol {TOL[dname]:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("flash_verify disagrees with its "
                                         "plain version")


def phase_kernels():
    """Kernel against plain version at the four geometries, both dtypes
    and blocks of 16 and 8, and the verify entry on speculative windows;
    then the timing at the serving phase's shapes (llama3.2-1b for the
    records, and qwen2-7b's hd 128). Returns the kernel records (without
    launches)."""
    import torch
    from repro_torch.kernels.flash_prefill import kernel as fp_kernel
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    fns = {"decode": (pa_kernel.paged_attention, paged_attention_ref),
           "prefill": (fp_kernel.flash_prefill, flash_prefill_ref),
           "verify": (fp_kernel.flash_verify, flash_prefill_ref)}
    check_lens = {
        # cur_len: the 0-row, a single position, a full row, the decode
        # kernel's partition edges (63, 64, 65: 64 positions a partition),
        # ragged rest
        "decode": [0, 1, 2048, 17, 63, 64, 65, 500, 1023, 1999],
        # q_off: ragged, incl. a chunk that runs past the table's end and
        # chunks whose rows end inside a 64-key tile (5, 300, 1000)
        "prefill": [0, 1, 5, 300, 1000, 1900, 2048 - 64, 128],
    }
    seed = 0
    for arch, H, KV, hd in GEOMETRIES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for kind in ("decode", "prefill"):
                for block in (16, 8):
                    seed += 1
                    args = make_case(kind, seed, H, KV, hd, dtype,
                                     check_lens[kind], block=block)
                    kern, plain = fns[kind]
                    out = kern(*args)
                    torch.cuda.synchronize()
                    ref = plain(*args)
                    err = (out.float() - ref.float()).abs().max().item()
                    ok = torch.allclose(out.float(), ref.float(),
                                        atol=TOL[dname], rtol=TOL[dname])
                    if kind == "decode":
                        ok = ok and torch.count_nonzero(out[0]).item() == 0
                    log(f"[kernels] check {kind:7s} {arch:11s} H={H} KV={KV}"
                        f" hd={hd} block={block:2d} {dname:8s}: max |kernel "
                        f"- plain| = {err:.3e} (tol {TOL[dname]:g}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{kind} kernel disagrees with "
                                             f"its plain version")

    check_verify(fns)
    records = [time_block_table(kind, name, GEOMETRIES[0], fns)
               for kind, name in (("decode", "paged_attention"),
                                  ("prefill", "flash_prefill"),
                                  ("verify", "flash_verify"))]
    for kind, name in (("decode", "paged_attention"),
                       ("prefill", "flash_prefill")):
        time_block_table(kind, name, GEOMETRIES[1], fns)
    return records


LOOP_ITERS = 200    # §6.1: 200 iterations of x = tanh(x @ w)
LOOP_TOL = 1e-6     # the same fp32 kernels; cuBLAS may pick another
#                     algorithm under capture


def phase_loop_overhead():
    """The paper's §6.1 measurement (the JAX package's
    ``benchmarks/bench_loop_overhead.py``): 200 iterations of
    ``x = tanh(x @ w)``, x (8, 128), w (128, 128), fp32, as a Python
    loop of eager steps, as ``core.while_loop`` with the host-read
    predicate, and as ``core.while_loop(impl="graph")`` (captured once,
    timed apart, then replayed: one graph launch a loop). Prints the
    route the graph lowering takes, iterations per second each way, and
    the device time per iteration by kernel; the three results must
    agree within LOOP_TOL."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import core
    from repro_torch.core import device_loop
    n = LOOP_ITERS
    has_if = hasattr(torch.cuda.CUDAGraph, "get_currently_capturing_graph")
    log(f"[loop] graph lowering: WHILE node around child graphs, IF nodes "
        f"built by graph_loop.cu (torch {torch.__version__} exposes "
        f"begin_capture_to_if_node: {has_if})")
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(128, 128, generator=gen) / 128 ** 0.5).to("cuda")
    x0 = torch.randn(8, 128, generator=gen).to("cuda")
    carry = (x0.clone(), torch.zeros((), dtype=torch.int32, device="cuda"))

    def cond_fn(c):
        return c[1] < n

    def body_fn(c):
        return torch.tanh(c[0] @ w), c[1] + 1

    def restart(c):
        c[0].copy_(x0)
        c[1].zero_()

    def python_loop():
        x = x0
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    def host_loop():
        return core.while_loop(cond_fn, body_fn, (
            x0, torch.zeros((), dtype=torch.int32, device="cuda")))[0]

    def graph_loop():
        return core.while_loop(cond_fn, body_fn, carry, impl="graph",
                               prologue=restart)[0]

    def per_call(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps, out

    with torch.no_grad():
        py_s, py_x = per_call(python_loop)
        reads = core.while_loop.host_reads
        host_s, host_x = per_call(host_loop)
        host_reads = (core.while_loop.host_reads - reads) // 21
        captures = device_loop.DeviceLoop.captures
        t0 = time.perf_counter()
        graph_loop()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        reads = core.while_loop.host_reads
        graph_s, graph_x = per_call(graph_loop)
        if device_loop.DeviceLoop.captures != captures + 1 or \
                core.while_loop.host_reads != reads:
            raise AssertionError("the graph loop recaptured or read the "
                                 "host")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph_loop()
        end.record()
        end.synchronize()
        graph_dev_ms = start.elapsed_time(end) / 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            python_loop()
            torch.cuda.synchronize()
    err = max(float((a - py_x).abs().max()) for a in (host_x, graph_x))
    rate = {k: n / v for k, v in (("python", py_s), ("host-read", host_s),
                                  ("graph", graph_s))}
    log(f"[loop] {n} iterations of tanh(x @ w), x (8, 128), w (128, 128) "
        f"fp32: Python loop {py_s * 1e3:.3f} ms ({rate['python']:.0f} it/s)"
        f"; while_loop host-read {host_s * 1e3:.3f} ms "
        f"({rate['host-read']:.0f} it/s, {host_reads} predicate reads); "
        f"while_loop graph {graph_s * 1e3:.3f} ms ({rate['graph']:.0f} "
        f"it/s; device {graph_dev_ms:.3f} ms a loop); graph / host-read "
        f"{rate['graph'] / rate['host-read']:.2f}x, graph / Python "
        f"{rate['graph'] / rate['python']:.2f}x; capture and first replay "
        f"{first_s * 1e3:.1f} ms; max |difference| {err:.2e}")
    for r in sorted(prof.key_averages(),
                    key=lambda r: -r.self_device_time_total)[:4]:
        if r.self_device_time_total:
            log(f"[loop]   Python loop's device time by kernel: "
                f"{r.self_device_time_total / n:8.2f} us an iteration, "
                f"{r.count // n}x  {r.key[:70]}")
    if err > LOOP_TOL:
        raise AssertionError(f"loop lowerings disagree: {err:.2e}")
    device_loop.release(body_fn)


def serving_requests(cfg, n=16, prompt_len=512):
    """n requests of ``prompt_len`` random tokens (numpy seed 0),
    ``max_new`` alternating 32 and 64."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [(rng.integers(2, cfg.vocab, (1, prompt_len)).astype(np.int32),
             32 if i % 2 == 0 else 64) for i in range(n)]


def scan_case(seed, B, Q, Di, N):
    """Operands of one selective-scan chunk on the card, as
    mamba1_forward makes them (softplus'd steps, A = -exp(A_log)), with
    a non-zero incoming state."""
    import torch
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    dt = torch.nn.functional.softplus(randn(B, Q, Di) - 1.0)
    A = -torch.exp(0.5 * randn(Di, N))
    return [t.cuda() for t in (dt, A, randn(B, Q, N), randn(B, Q, N),
                               randn(B, Q, Di), randn(B, Di, N))]


def scan_bound(dt, A, B_, C_, x, h0):
    """(bound_ms, bound_by) of one chunk: bytes (dt, x, B_, C_, A, h0
    read once; y, h_out written once) over HBM bandwidth, against the
    B*Q*Di*N exponentials at the SFU's rate at the card's top SM clock
    (the multiply-adds beside them need less time at the fp32 rate)."""
    Bn, Q, Di = x.shape
    N = A.shape[1]
    nbytes = 4 * (3 * Bn * Q * Di + 2 * Bn * Di * N + Di * N
                  + 2 * Bn * Q * N)
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    exps = Bn * Q * Di * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(exps / (SMS * SFU_PER_CLOCK * clock_hz),
                4 * exps / PEAK_FLOPS["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_chain(chunk, kern):
    """The call site before the one-call scan, written out: ``kern``
    over ``chunk``-step slices, each copied contiguous, h carried."""
    import torch

    def chain(dt, A, B_, C_, x, h0):
        ys, h = [], h0
        for c in range(0, x.shape[1], chunk):
            sl = slice(c, c + chunk)
            y, h = kern(dt[:, sl].contiguous(), A, B_[:, sl].contiguous(),
                        C_[:, sl].contiguous(), x[:, sl].contiguous(), h)
            ys.append(y)
        return torch.cat(ys, dim=1), h
    return chain


def sass_counts(name, opcodes):
    """How often each of ``opcodes`` appears in the SASS of the built
    library of ``csrc/<name>.cu`` (``cuobjdump -sass``)."""
    from repro_torch import kernels
    kernels.library(name)                        # built, if it is not yet
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    # its exit code is 1 on a shared library (the host part holds no device
    # code) though it dumps the device code it finds
    sass = subprocess.run([str(tool), "-sass", str(kernels._lib_path(name))],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True).stdout
    if "Function :" not in sass:
        raise RuntimeError(f"cuobjdump found no kernels in {name}'s "
                           f"library: {sass[:500]}")
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
            for op in opcodes}


def resource_usage(name):
    """``{kernel: (registers, stack bytes, local bytes)}`` for each kernel
    instance in the built library of ``csrc/<name>.cu`` (``cuobjdump
    -res-usage``). A stack frame of 0 bytes means ptxas spilled
    nothing."""
    from repro_torch import kernels
    kernels.library(name)
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-res-usage",
                          str(kernels._lib_path(name))],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True).stdout
    rows = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) "
                      r"SHARED:\d+ LOCAL:(\d+)", out)
    if not rows:
        raise RuntimeError(f"cuobjdump -res-usage found no kernels in "
                           f"{name}'s library: {out[:500]}")
    names = demangle([r[0] for r in rows])
    return {n: tuple(map(int, r[1:])) for n, r in zip(names, rows)}


def phase_scan_kernel():
    """The selective-scan kernel against its plain version; one launch
    over a 512-step layer against four chained 128-step launches (bit for
    bit); then timed at the serving chunk and at the per-layer call.
    Returns its record (launches 0: the serving phase fills them in)."""
    import torch
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    kern = ss_kernel.selective_scan
    # the design's exponential (ex2.approx) and its TMA loads and stores
    sass = sass_counts("selective_scan", ("MUFU.EX2", "UTMALDG", "UTMASTG"))
    log(f"[scan] SASS of the built kernel: {sass}")
    if not all(sass.values()):
        raise AssertionError(f"the built scan lacks an opcode of its design: "
                             f"{sass}")
    usage = {k: u for k, u in resource_usage("selective_scan").items()
             if "selective_scan_kernel" in k}
    log(f"[scan] registers, stack and local bytes: {usage}")
    if len(usage) != 2 or any(stack or local
                              for _, stack, local in usage.values()):
        raise AssertionError("want the two scan instances (N = 8, 16) with "
                             f"no stack frame (no spill): {usage}")
    cases = (("falcon-mamba-7b chunk", 8, 128, 8192, 16),
             ("one row", 1, 128, 8192, 16),
             ("odd Q, full width", 3, 77, 8192, 16),
             ("smoke width, odd Q", 3, 13, 128, 8),
             ("smoke chunk", 8, 8, 128, 8),
             ("falcon-mamba-7b layer", 8, SCAN_LAYER, 8192, 16),
             ("Q = 1, ragged Di", 3, 1, 324, 16))
    for seed, (what, *shape) in enumerate(cases):
        args = scan_case(seed, *shape)
        y, h = kern(*args)
        torch.cuda.synchronize()
        y_ref, h_ref = selective_scan_ref(*args)
        err_y = (y - y_ref).abs().max().item()
        err_h = (h - h_ref).abs().max().item()
        ok = all(torch.allclose(a, b, rtol=SCAN_TOL, atol=SCAN_TOL)
                 for a, b in ((y, y_ref), (h, h_ref)))
        log(f"[scan] check {what:22s} B,Q,Di,N={tuple(shape)}: max |kernel "
            f"- plain| y {err_y:.3e}, h_out {err_h:.3e} (tol {SCAN_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("selective_scan disagrees with its plain "
                                 "version")
    args = scan_case(50, 8, SCAN_LAYER, 8192, 16)
    y, h = kern(*args)
    y_c, h_c = scan_chain(SCAN_CHUNK, kern)(*args)
    same = torch.equal(y, y_c) and torch.equal(h, h_c)
    log(f"[scan] one launch over {SCAN_LAYER} steps vs "
        f"{SCAN_LAYER // SCAN_CHUNK} chained {SCAN_CHUNK}-step launches: y "
        f"and h_out {'identical' if same else 'DIFFER'} (torch.equal)")
    if not same:
        raise AssertionError("one scan launch differs from the chunk chain")
    del args, y, h, y_c, h_c

    copies = [scan_case(100 + i, 8, SCAN_CHUNK, 8192, 16) for i in range(4)]
    y, h = kern(*copies[0])
    y_ref, h_ref = selective_scan_ref(*copies[0])
    err = max((y - y_ref).abs().max().item(), (h - h_ref).abs().max().item())
    times = call_times(lambda i: kern(*copies[i]), len(copies))
    plain_ms = time_ms(lambda i: selective_scan_ref(*copies[i]),
                       len(copies), iters=5)
    b_ms, b_by = scan_bound(*copies[0])
    log(f"[scan] time selective_scan at the serving chunk B,Q,Di,N=(8, "
        f"{SCAN_CHUNK}, 8192, 16) fp32: {fmt_times(times)}, plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), library: none "
        f"(no single PyTorch call computes this recurrence), max |kernel - "
        f"plain| {err:.3e}")
    record = kernel_record("selective_scan", err, times, plain_ms, b_ms,
                           b_by)
    del copies, y, h, y_ref, h_ref

    copies = [scan_case(110 + i, 8, SCAN_LAYER, 8192, 16) for i in range(4)]
    layer = call_times(lambda i: kern(*copies[i]), len(copies))
    chain = scan_chain(SCAN_CHUNK, kern)
    chain_ms = graph_ms(lambda i: chain(*copies[i]), len(copies))
    l_ms, l_by = scan_bound(*copies[0])
    n_chunks = SCAN_LAYER // SCAN_CHUNK
    log(f"[scan] time the per-layer call B,Q,Di,N=(8, {SCAN_LAYER}, 8192, "
        f"16) fp32: one launch: {fmt_times(layer)}; the chunk chain "
        f"({n_chunks} launches of {SCAN_CHUNK} steps and their contiguous "
        f"copies) {chain_ms:.4f} ms device; bound {l_ms:.4f} ms ({l_by})")
    record.update(layer_ms=layer["ms"], layer_eager_ms=layer["eager_ms"],
                  layer_chain_ms=chain_ms, layer_bound_ms=l_ms,
                  layer_bound_by=l_by)
    return record


def free_device_memory(what):
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] before {what}: {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated")


def make_ssm_scheduler(params, cfg, loop=None):
    from repro_torch.serve import scheduler as sched_lib
    return sched_lib.DecodeScheduler(
        params, cfg, n_slots=8, prompt_len=512, max_new_cap=64, eos_id=-1,
        prefill="oneshot", loop=loop)


def time_admissions(sched):
    """Wall time of each one-shot admission (prefill + splice),
    synchronised on both sides: the segment that follows waits for the
    admission anyway, and before it the device is idle."""
    import torch
    spans = []
    admit = sched._admit

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit(*args)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)

    sched._admit = timed
    return spans


def launch_counters():
    """The Python-side counters the serving gates read: each kernel
    wrapper's launches and ``PagedView.gather`` calls."""
    from repro_torch.kernels.flash_prefill import kernel as fp_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.serve.kv_cache import PagedView
    return {"paged_attention": (pa_kernel.paged_attention, "launches"),
            "flash_prefill": (fp_kernel.flash_prefill, "launches"),
            "flash_verify": (fp_kernel.flash_verify, "launches"),
            "selective_scan": (ss_kernel.selective_scan, "launches"),
            "gather": (PagedView, "gather_calls")}


def check_streams(streams, reqs, cfg):
    if sorted(streams) != list(range(len(reqs))):
        raise AssertionError(f"finished {sorted(streams)} of {len(reqs)}")
    for rid, (_, max_new) in enumerate(reqs):
        toks = streams[rid]
        if len(toks) != max_new or toks.min() < 0 or \
                toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"request {rid}: bad stream {toks}")


def check_graph_run(tag, sched, launches, reads):
    """The gates of a graph-segment run: the graph path ran, one host
    read per segment (the harvest) and none elsewhere (``reads``: the
    process's one-transfer reads and the host loop's predicate reads in
    the run), and the launches the device
    counted equal each wrapper's count at capture times the device's runs
    of its branch. (``serve_in_turns`` also holds them to the host-read
    run's.)"""
    from repro_torch.serve import scheduler as sched_lib
    if not sched.loop_impl.startswith("cuda-graph:"):
        raise AssertionError(f"{tag}: segment ran {sched.loop_impl}")
    if not sched.host_reads == sched.segments == sched.graph_replays > 0:
        raise AssertionError(
            f"{tag}: {sched.host_reads} host reads, {sched.graph_replays} "
            f"graph launches for {sched.segments} segments")
    if reads != (sched.segments, 0):
        raise AssertionError(f"{tag}: (transfers, predicate reads) "
                             f"{reads} in a run of {sched.segments} graph "
                             f"segments")
    runs = {"chunk": int(sched._counts[2]), "decode": int(sched._counts[3])}
    for i, name in enumerate(sched_lib._COUNTED):
        want = sum(per[i] * runs[key]
                   for key, per in sched._per_branch.items())
        if launches[name] != want:
            raise AssertionError(
                f"{tag}: {name} launches {launches[name]} (device-counted)"
                f" != captured counts {sched._per_branch} x branch runs "
                f"{runs}")
    return runs


def instrument_sync(sched):
    """CUDA events around each segment and its one host read (the
    harvest): event S when the host starts the segment (the device
    reaches it when the admission before it is done), event A just
    before the read (the device reaches it when the segment's graph has
    run), event B when the harvest returns and the host goes on to the
    next round. The device runs the segment from S to A (its kernels and
    the graph's own gaps between them) and is idle from A to B: that gap
    is what the per-segment sync costs. ``finish()`` removes the
    instrument and returns (idle share of the device span, idle ms per
    segment, segments, ms the device spent in segments)."""
    import torch
    marks, starts = [], []
    harvest, segment = sched._harvest, sched._segment

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed_segment(*args):
        starts.append(event())
        return segment(*args)

    def timed_harvest():
        a = event()
        out = harvest()
        marks.append((a, event()))
        return out

    sched._segment, sched._harvest = timed_segment, timed_harvest

    def finish():
        del sched._segment, sched._harvest
        torch.cuda.synchronize()
        gaps = [a.elapsed_time(b) for a, b in marks]
        in_segments = sum(s.elapsed_time(a)
                          for s, (a, _) in zip(starts, marks))
        span = marks[0][0].elapsed_time(marks[-1][1]) if marks else 0.0
        return (sum(gaps) / span if span else 0.0,
                sum(gaps) / max(len(gaps), 1), len(gaps), in_segments)

    return finish


def serve_in_turns(tag, cfg, make, reqs, admissions=False, profile=True):
    """The same requests through the graph segment and the host-read
    segment, in turns (graph, host, host, graph), each scheduler warmed
    (and the graph one captured) first. Gates every run's streams and
    each graph run's one-read-per-segment and launch counts, and every
    run's launches against the first host-read run's; prints tok/s,
    iterations, segments, host reads, graph launches and kernel launches
    per run, the per-segment sync and the device's time in segments (a
    graph run's busy share, from CUDA events), how many bf16 streams the
    two paths share, and (``profile``) a profiled run of 8 requests on
    each path (host launches per iteration; the host-read run's kernel
    time, its busy share). A speculative scheduler's runs also print its
    accept rate and mean accept length. Returns the first graph run's
    launch counts and the runs; both schedulers are closed."""
    import torch
    from repro_torch import core
    from repro_torch.core.device_loop import DeviceLoop
    counters = launch_counters()
    scheds, spans = {}, {}
    for loop in ("graph", "host"):
        sched = make(loop)
        t0 = time.perf_counter()
        sched.warmup()
        warm = time.perf_counter() - t0
        drive(sched, reqs[:1])               # warm-up, not measured
        torch.cuda.synchronize()
        if admissions:
            spans[loop] = time_admissions(sched)
        scheds[loop] = sched
        if loop == "graph":
            log(f"[{tag}] graph segment: warm-up body and capture "
                f"{warm:.3f} s, of which capture {sched.capture_seconds:.3f}"
                f" s ({sched.loop_impl})")
    runs = []
    for loop in ("graph", "host", "host", "graph"):
        sched = scheds[loop]
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        if admissions:
            spans[loop].clear()
        reads0 = (DeviceLoop.host_reads, core.while_loop.host_reads)
        finish = instrument_sync(sched) if loop == "graph" else None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        streams = drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: getattr(o, a) for n, (o, a) in counters.items()}
        check_streams(streams, reqs, cfg)
        run = {"loop": sched.loop_impl, "attn_impl": sched.attn_impl,
               "prefill_impl": sched.prefill_impl, "wall": wall,
               "tok_s": sched.tokens_emitted / wall,
               "iterations": sched.total_steps, "segments": sched.segments,
               "host_reads": sched.host_reads,
               "graph_launches": sched.graph_replays, "launches": launches,
               "streams": streams, "admissions": list(spans.get(loop, [])),
               "accept_rate": sched.accept_rate,
               "mean_accept_len": sched.mean_accept_len,
               "spec_windows": sched.spec_windows}
        line = (f"[{tag}] {run['loop']} ({run['attn_impl']} / "
                f"{run['prefill_impl']}): {sched.tokens_emitted} tokens in "
                f"{wall:.3f} s -> {run['tok_s']:.1f} tok/s, "
                f"{run['iterations']} iterations, occupancy "
                f"{sched.occupancy:.3f}, {run['segments']} segments, "
                f"{run['host_reads']} host reads, {run['graph_launches']} "
                f"graph launches; kernel launches "
                f"{ {n: v for n, v in launches.items() if v} }; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if sched.speculative is not None:
            line += (f"; speculation k={sched.speculative.k}: "
                     f"{sched.spec_windows} windows, accept rate "
                     f"{sched.accept_rate:.4f}, mean accept length "
                     f"{sched.mean_accept_len:.4f}")
        if loop == "graph":
            runs_by_branch = check_graph_run(
                tag, sched, launches,
                (DeviceLoop.host_reads - reads0[0],
                 core.while_loop.host_reads - reads0[1]))
            share, ms, n, seg_ms = finish()
            run["seg_ms"] = seg_ms
            line += (f"; device idle at the per-segment read {ms:.4f} ms x "
                     f"{n} = {share:.4f} of the device span; device in "
                     f"segments {seg_ms:.1f} ms = {seg_ms / 1e3 / wall:.3f} "
                     f"of the wall (events: kernels and the graph's gaps); "
                     f"branch runs {runs_by_branch}, captured counts "
                     f"{sched._per_branch}")
        if admissions:
            line += (f"; admissions {sum(run['admissions']):.3f} s of the "
                     f"wall ({', '.join(f'{a:.3f}' for a in run['admissions'])}"
                     f" s)")
        log(line)
        runs.append(run)
    for run in runs:        # device-counted (graph) against Python-counted
        if run["launches"] != runs[1]["launches"]:
            raise AssertionError(
                f"{tag}: {run['loop']} launches {run['launches']} != the "
                f"host-read run's {runs[1]['launches']}")
    g, h = runs[0]["streams"], runs[1]["streams"]
    same = sum(len(g[r]) == len(h[r]) and bool((g[r] == h[r]).all())
               for r in g)
    log(f"[{tag}] bf16 greedy streams equal between the graph and "
        f"host-read segments for {same}/{len(reqs)} requests (not a gate: "
        f"bf16 at random full-width weights)")
    # host launches per iteration on each path; the host-read run's
    # device-busy share from the profiler (its records of kernels inside
    # a graph's conditional nodes are unreliable, so a graph run's share
    # is the events' one above)
    if profile:
        sub = reqs[:8]
        profile_serving(scheds["host"], sub, tag)
        profile_serving(scheds["graph"], sub, tag, device=False)
    for sched in scheds.values():
        sched.close()
    return runs[0]["launches"], runs


def phase_ssm_serve():
    """falcon-mamba-7b at full width through one-shot admission with
    the selective-scan kernel, graph segments against host-read ones;
    returns the kernel's launch count in the first graph run."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config

    base = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, scan_impl="cuda"))
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[ssm-serve] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, d_state {cfg.ssm.d_state}, "
        f"vocab {cfg.vocab}; bf16 weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB made in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = serving_requests(cfg)
    launches, runs = serve_in_turns(
        "ssm-serve", cfg, lambda loop: make_ssm_scheduler(params, cfg, loop),
        reqs, admissions=True)
    for run in runs:
        n_adm = len(run["admissions"])
        if run["launches"]["selective_scan"] != cfg.n_layers * n_adm:
            raise AssertionError(
                f"kernel path not taken once per layer per admission: "
                f"launches {run['launches']['selective_scan']} for {n_adm} "
                f"admissions of {cfg.n_layers} layers ({run['loop']})")
    log(f"[ssm-serve] {cfg.name} bf16, attention-free, scan_impl "
        f"{cfg.ssm.scan_impl} (selective_scan kernel), one-shot, 8 slots, "
        f"{len(reqs)} requests: selective_scan {launches['selective_scan']}"
        f" launches in the first graph run (one call per layer per "
        f"admission: {cfg.n_layers} layers x {len(runs[0]['admissions'])} "
        f"admissions)")
    profile_admission(params, cfg, reqs[:8])
    return launches["selective_scan"]


def profile_admission(params, cfg, reqs):
    """One one-shot prefill of ``reqs`` (8 x 512 tokens, what an
    admission runs) under the profiler: the selective-scan kernel's device
    ms and launches, and the copy kernels' (casts and contiguous copies)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import engine
    tokens = torch.from_numpy(np.concatenate([p for p, _ in reqs])).to(
        "cuda", torch.long)
    engine.prefill(params, cfg, tokens, None)        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.prefill(params, cfg, tokens, None)
        torch.cuda.synchronize()
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA]

    def total(pick):
        rows = [r for r in kernels if pick(r.key)]
        return (sum(r.self_device_time_total for r in rows) / 1e3,
                sum(r.count for r in rows))
    scan_ms, scan_n = total(lambda k: "selective_scan" in k)
    copy_ms, copy_n = total(lambda k: "copy" in k.lower())
    busy_ms, _ = total(lambda k: True)
    log(f"[ssm-serve] profiled admission ({tokens.shape[0]} x "
        f"{tokens.shape[1]} tokens): device {busy_ms:.2f} ms; selective_scan "
        f"{scan_ms:.3f} ms in {scan_n} launches; copy kernels (casts and "
        f"contiguous copies) {copy_ms:.3f} ms in {copy_n}")


def parity_runs(tag, make, reqs, variants):
    """fp32 greedy streams of ``reqs`` for each (name, cfg, loop) or
    (name, cfg, loop, scheduler arguments) of ``variants``; {name: {rid:
    tokens}}."""
    import torch
    runs = {}
    for name, cfg, loop, *extra in variants:
        sched = make(cfg, loop, **(extra[0] if extra else {}))
        t0 = time.perf_counter()
        runs[name] = drive(sched, reqs)
        torch.cuda.synchronize()
        spec = ("" if sched.speculative is None else
                f"; {sched.spec_windows} verify windows, accept rate "
                f"{sched.accept_rate:.4f}")
        log(f"[{tag}] fp32 {name} ({sched.loop_impl}): "
            f"{sched.tokens_emitted} tokens in "
            f"{time.perf_counter() - t0:.2f} s{spec}")
        sched.close()
    return runs


def same_streams(tag, runs, a, b, what):
    n = len(runs[a])
    same = [len(runs[a][r]) == len(runs[b][r])
            and bool((runs[a][r] == runs[b][r]).all()) for r in range(n)]
    log(f"[{tag}] greedy streams identical, {a} vs {b}: {sum(same)}/{n} "
        f"requests")
    if not all(same):
        raise AssertionError(f"{what} disagree in fp32")


def phase_ssm_parity():
    """8 of the serving requests in fp32 through the kernel's scan in
    graph segments, the kernel's scan in host-read segments and the
    plain blocked scan: greedy streams must be identical."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config("falcon-mamba-7b"),
                               compute_dtype="float32")
    params = bridge.init_params(base, seed=0, device="cuda")
    reqs = serving_requests(base)[:8]

    def scan(impl):
        return dataclasses.replace(base, ssm=dataclasses.replace(
            base.ssm, scan_impl=impl))
    runs = parity_runs(
        "ssm-parity", lambda c, loop: make_ssm_scheduler(params, c, loop),
        reqs, [("cuda-graph", scan("cuda"), None),
               ("cuda-host-read", scan("cuda"), "host"),
               ("blocked-graph", scan("blocked"), None)])
    same_streams("ssm-parity", runs, "cuda-graph", "cuda-host-read",
                 "graph segments and host-read segments")
    same_streams("ssm-parity", runs, "cuda-graph", "blocked-graph",
                 "selective-scan kernel path and blocked path")


def make_scheduler(params, cfg, loop=None, **kw):
    """The chunked paged serving pool: 8 slots, block 16, chunk 128;
    ``kw`` adds or overrides arguments (sampling, speculation, slots)."""
    from repro_torch.serve import scheduler as sched_lib
    # eos_id -1 is never sampled: every request runs to its max_new, so
    # the work is the same from run to run
    args = dict(n_slots=8, prompt_len=512, max_new_cap=64, eos_id=-1,
                kv="paged", kv_block=16, prefill="chunked",
                chunk_tokens=128, loop=loop)
    return sched_lib.DecodeScheduler(params, cfg, **{**args, **kw})


def drive(sched, reqs):
    """Submit every request at once and drain; {rid: tokens}."""
    for rid, (prompt, max_new) in enumerate(reqs):
        sched.submit(prompt, max_new=max_new, request_id=rid)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}


def phase_serve():
    """llama3.2-1b at full width through the chunked paged scheduler
    with both kernels, graph segments against host-read ones; returns
    the kernels' launch counts in the first graph run."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device="cuda")
    reqs = serving_requests(cfg)
    launches, runs = serve_in_turns(
        "serve", cfg, lambda loop: make_scheduler(params, cfg, loop), reqs)
    for run in runs:
        got = run["launches"]
        if min(got["paged_attention"], got["flash_prefill"]) == 0 or \
                got["gather"] != 0:
            raise AssertionError(f"kernel path not taken ({run['loop']}): "
                                 f"launches {got}")
    log(f"[serve] {cfg.name} bf16, {runs[0]['attn_impl']} / "
        f"{runs[0]['prefill_impl']}, 8 slots, chunk 128, {len(reqs)} "
        f"requests: launches in the first graph run {launches}")
    return {k: launches[k] for k in ("paged_attention", "flash_prefill")}


def profile_serving(sched, reqs, tag, device=True):
    """Where the serving loop's time goes: a further, profiled run of
    ``reqs`` (after the measured ones, so the profiler's own cost is
    kept out of the serving numbers). Prints the host's launches per
    iteration (kernel launches and graph launches) and, with ``device``,
    the device's busy share of the wall time and the top kernels;
    returns the device ms (None without ``device``). A graph segment's
    kernels are left out (``device=False``): the profiler delivers the
    records of kernels inside conditional nodes late and in part, into
    later sessions (PERF.md §6)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device
                                     else [])
    sched.reset_stats()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive(sched, reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = prof.key_averages()
    n_kernel = sum(r.count for r in rows if r.key in (
        "cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
        "cudaLaunchKernelExC"))
    n_graph = sum(r.count for r in rows if "GraphLaunch" in r.key)
    it = max(sched.total_steps, 1)
    line = (f"[profile] {tag} {sched.loop_impl}, {len(reqs)} requests, "
            f"{sched.total_steps} iterations, {sched.segments} segments, "
            f"{wall_us / 1e3:.1f} ms wall: host launches per iteration "
            f"{n_kernel / it:.1f} kernels, {n_graph / it:.3f} graphs "
            f"({n_kernel} and {n_graph} in all)")
    if not device:
        log(line)
        return None
    kernels = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(r.self_device_time_total for r in kernels)
    log(f"{line}; device busy {dev_us / 1e3:.1f} ms "
        f"({dev_us / wall_us:.3f} of the profiled wall)")
    top = sorted(kernels, key=lambda r: -r.self_device_time_total)[:6]
    for r in top:
        log(f"[profile]   {r.self_device_time_total / 1e3:9.2f} ms "
            f"{r.count:6d}x  {r.key[:70]}")
    for r in sorted(kernels, key=lambda r: -r.self_device_time_total):
        if "repro::" in r.key:       # the port's own kernels
            m = re.search(r"(\w+<[^()]*>)\(", r.key)
            log(f"[profile]   port kernel {r.self_device_time_total / 1e3:9.3f}"
                f" ms {r.count:6d}x  {m.group(1) if m else r.key[:70]}")
    return dev_us / 1e3


def phase_parity():
    """The first 8 requests in fp32 through the kernel path in graph
    segments, in host-read segments, and the gather path: greedy streams
    must be identical."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              compute_dtype="float32")
    params = bridge.init_params(cfg, seed=0, device="cuda")
    reqs = serving_requests(cfg)[:8]
    kern = dataclasses.replace(cfg, attn_impl="cuda")
    runs = parity_runs(
        "parity", lambda c, loop: make_scheduler(params, c, loop), reqs,
        [("cuda-graph", kern, None), ("cuda-host-read", kern, "host"),
         ("gather-graph", dataclasses.replace(cfg, attn_impl="gather"),
          None)])
    same_streams("parity", runs, "cuda-graph", "cuda-host-read",
                 "graph segments and host-read segments")
    same_streams("parity", runs, "cuda-graph", "gather-graph",
                 "kernel path and gather path")


def repetitive_requests(cfg, n=16, prompt_len=512, period=32):
    """``serving_requests``' shape, but each prompt tiles one random
    ``period``-token segment (numpy seed 1): traffic the n-gram drafter
    accepts on."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [(np.resize(rng.integers(2, cfg.vocab, period),
                       prompt_len)[None].astype(np.int32),
             32 if i % 2 == 0 else 64) for i in range(n)]


def spec_config(**kw):
    from repro_torch.serve import speculative as spec_lib
    return spec_lib.SpecConfig(k=SPEC_K, **kw)


def graph_run(tag, sched, reqs):
    """One timed run of ``reqs`` through a graph-segment scheduler, after
    its capture and a one-request warm-up: tok/s, and the device's time
    in segments (CUDA events, ``instrument_sync``) per loop iteration.
    Returns the run's numbers and streams; the scheduler is closed."""
    import torch
    sched.warmup()
    drive(sched, reqs[:1])
    torch.cuda.synchronize()
    finish = instrument_sync(sched)
    t0 = time.perf_counter()
    streams = drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, _, _, seg_ms = finish()
    check_streams(streams, reqs, sched.cfg)
    run = {"tok_s": sched.tokens_emitted / wall, "wall": wall,
           "iterations": sched.total_steps, "seg_ms": seg_ms,
           "ms_per_iter": seg_ms / max(sched.total_steps, 1),
           "streams": streams, "accept_rate": sched.accept_rate,
           "mean_accept_len": sched.mean_accept_len}
    log(f"[{tag}] {sched.loop_impl}, {sched.n_slots} slots: "
        f"{sched.tokens_emitted} tokens in {wall:.3f} s -> "
        f"{run['tok_s']:.1f} tok/s, {run['iterations']} iterations, device "
        f"in segments {seg_ms:.1f} ms = {run['ms_per_iter']:.4f} ms an "
        f"iteration"
        + ("" if sched.speculative is None else
           f"; accept rate {sched.accept_rate:.4f}, mean accept length "
           f"{sched.mean_accept_len:.4f}"))
    sched.close()
    return run


def phase_spec_serve():
    """llama3.2-1b at full width speculating (k = 4, n-gram drafter)
    through the chunked paged scheduler: graph segments against host-read
    ones in turns, on the serving requests and on a repetitive variant,
    each beside the non-speculative graph run of the same requests.
    Returns flash_verify's launches in the first graph run."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device="cuda")
    first = None
    for name, reqs in (("serving", serving_requests(cfg)),
                       ("repetitive", repetitive_requests(cfg))):
        tag = f"spec-serve {name}"
        plain = graph_run(f"{tag} non-speculative",
                          make_scheduler(params, cfg), reqs)
        launches, runs = serve_in_turns(
            tag, cfg, lambda loop: make_scheduler(
                params, cfg, loop, speculative=spec_config()),
            reqs, profile=name == "serving")
        for run in runs:
            got = run["launches"]
            if got["flash_verify"] == 0 or got["gather"] != 0 or \
                    got["paged_attention"] != 0:
                raise AssertionError(f"{tag}: verify path not taken "
                                     f"({run['loop']}): launches {got}")
        g = runs[0]
        log(f"[{tag}] {cfg.name} bf16, k={SPEC_K} n-gram: graph "
            f"{g['tok_s']:.1f} tok/s (non-speculative graph "
            f"{plain['tok_s']:.1f}), host-read {runs[1]['tok_s']:.1f}; "
            f"accept rate {g['accept_rate']:.4f}, mean accept length "
            f"{g['mean_accept_len']:.4f}; device in segments "
            f"{g['seg_ms'] / 1e3 / g['wall']:.3f} of the graph wall; "
            f"launches in the first graph run {launches}")
        if first is None:
            first = launches
    return first["flash_verify"]


def phase_spec_parity():
    """fp32: the first 8 serving and repetitive requests through the
    speculative kernel path in graph segments, in host-read segments,
    and the non-speculative graph path: greedy streams identical; then
    the model drafter at smoke width (smollm-135m drafting for the smoke
    llama3.2-1b at the kernels' head dim 64; both vocab 512), and the
    target drafting for itself, each against its host-read run and the
    non-speculative run."""
    import dataclasses
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              compute_dtype="float32", attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device="cuda")
    spec = dict(speculative=spec_config())
    for name, reqs in (("serving", serving_requests(cfg)[:8]),
                       ("repetitive", repetitive_requests(cfg)[:8])):
        tag = f"spec-parity {name}"
        runs = parity_runs(
            tag, lambda c, loop, **kw: make_scheduler(params, c, loop, **kw),
            reqs, [("spec-graph", cfg, None, spec),
                   ("spec-host-read", cfg, "host", spec),
                   ("plain-graph", cfg, None)])
        same_streams(tag, runs, "spec-graph", "spec-host-read",
                     "speculative graph and host-read segments")
        same_streams(tag, runs, "spec-graph", "plain-graph",
                     "speculative and non-speculative streams")
    del params
    small = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                                compute_dtype="float32", attn_impl="cuda",
                                head_dim=64, n_heads=8, n_kv_heads=2,
                                d_model=128)
    dcfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                               compute_dtype="float32")
    tp = bridge.init_params(small, seed=0, device="cuda")
    dp = bridge.init_params(dcfg, seed=1, device="cuda")
    rng = np.random.default_rng(3)
    reqs = [(np.resize(rng.integers(2, small.vocab, 4), n)[None].astype(
        np.int32), m) for n, m in ((48, 16), (20, 12), (64, 16), (7, 9),
                                   (33, 16), (50, 14))]
    model = dict(speculative=spec_config(drafter="model"), draft_params=dp,
                 draft_cfg=dcfg)

    def make(c, loop, **kw):
        return make_scheduler(tp, c, loop, **{
            **dict(n_slots=4, prompt_len=64, max_new_cap=16,
                   chunk_tokens=16), **kw})
    # the target drafting for itself accepts every window: k+1 tokens
    # land an iteration, so a fault in a multi-token landing would show
    itself = dict(speculative=spec_config(drafter="model"), draft_params=tp,
                  draft_cfg=small)
    runs = parity_runs("spec-parity model-drafter", make, reqs,
                       [("spec-graph", small, None, model),
                        ("spec-host-read", small, "host", model),
                        ("self-graph", small, None, itself),
                        ("self-host-read", small, "host", itself),
                        ("plain-graph", small, None)])
    for a, b in (("spec-graph", "spec-host-read"),
                 ("spec-graph", "plain-graph"),
                 ("self-graph", "self-host-read"),
                 ("self-graph", "plain-graph")):
        same_streams("spec-parity model-drafter", runs, a, b,
                     f"model-drafter streams {a} and {b}")


def phase_sampled():
    """Sampled decoding at llama3.2-1b's full width (bf16, the kernel
    path): temperature 0.8 with top-k 0 and 50, then speculation (k = 4,
    n-gram) greedy and at temperature 0.8, on the first 8 serving
    requests. Each sampled configuration runs in graph segments with 8
    slots, in host-read segments with 8, and in graph segments with 4:
    the streams must be identical (the same seed; keys by request and
    emission index). Prints tok/s and the device ms an iteration against
    greedy decoding's."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serve.sampling import SamplingParams

    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device="cuda")
    reqs = serving_requests(cfg)[:8]
    greedy = None
    for name, sp, spec in (
            ("greedy", SamplingParams(), None),
            ("t0.8", SamplingParams(temperature=0.8), None),
            ("t0.8 top-k 50", SamplingParams(temperature=0.8, top_k=50),
             None),
            ("spec greedy", SamplingParams(), spec_config()),
            ("spec t0.8", SamplingParams(temperature=0.8), spec_config())):
        tag = f"sampled {name}"
        kw = dict(sampling=sp, seed=0)
        if spec is not None:
            kw["speculative"] = spec
        run = graph_run(tag, make_scheduler(params, cfg, **kw), reqs)
        if greedy is None:
            greedy = run
        log(f"[{tag}] device ms an iteration {run['ms_per_iter']:.4f} "
            f"against greedy decoding's {greedy['ms_per_iter']:.4f} "
            f"({run['ms_per_iter'] / greedy['ms_per_iter']:.3f}x); tok/s "
            f"{run['tok_s']:.1f} against {greedy['tok_s']:.1f}")
        if sp.greedy:
            continue
        host = make_scheduler(params, cfg, "host", **kw)
        other = {"host-read, 8 slots": drive(host, reqs)}
        other["graph, 4 slots"] = graph_run(
            f"{tag} 4 slots", make_scheduler(params, cfg, n_slots=4, **kw),
            reqs)["streams"]
        for what, streams in other.items():
            same = sum(len(streams[r]) == len(run["streams"][r])
                       and bool((streams[r] == run["streams"][r]).all())
                       for r in range(len(reqs)))
            log(f"[{tag}] streams equal between graph, 8 slots and "
                f"{what}: {same}/{len(reqs)} requests")
            if same != len(reqs):
                raise AssertionError(f"{tag}: sampled streams differ "
                                     f"between graph, 8 slots and {what}")


def lstm_case(seed, B, D, H, dtype):
    """Operands of one LSTM step on the card at lstm_init's weight scale,
    with a non-zero bias and incoming state."""
    import torch
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    return [randn(D + H, 4 * H, scale=(D + H) ** -0.5), randn(4 * H,
                                                              scale=0.1),
            randn(B, D), randn(B, H), randn(B, H, scale=0.5)]


def lstm_bound(w, b, x, c, h):
    """(bound_ms, bound_by) of one step: every operand read once and c', h'
    written once over HBM bandwidth, against the 2*B*(D+H)*4H FLOPs of
    the product at the fp32 (or bf16 tensor-core) peak."""
    B, D = x.shape
    H = c.shape[1]
    isz = x.element_size()
    nbytes = isz * (w.numel() + b.numel() + x.numel() + 4 * c.numel())
    flops = 2 * B * (D + H) * 4 * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def aten_lstm_operands(w, b, x, c, h):
    """The same step for ``torch.lstm_cell``: its weights as (4H, D) and
    (4H, H), the forget gate's +1 folded into the input bias."""
    import torch
    D = x.shape[1]
    H = c.shape[1]
    b_ih = b.clone()
    b_ih[H:2 * H] += 1.0
    return (x, (h, c), w[:D].t().contiguous(), w[D:].t().contiguous(), b_ih,
            torch.zeros_like(b))


def phase_lstm_kernel():
    """The fused LSTM-cell kernel against its plain version, its autograd
    refusal, then its time at B=512, D=H=512 fp32. Returns its record
    (launches 0: the dynamic_rnn phase fills them in)."""
    import torch
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    kern = lstm_kernel.lstm_cell
    cases = (("dynamic_rnn step", 512, 512, 512), ("one row", 1, 512, 512),
             ("B=37, H=48", 37, 20, 48), ("NMT encoder", 32, 24, 48),
             ("NMT decoder", 32, 72, 48))
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = LSTM_TOL[dname]
        for what, B, D, H in cases:
            seed += 1
            args = lstm_case(seed, B, D, H, dtype)
            c, h = kern(*args)
            torch.cuda.synchronize()
            c_ref, h_ref = lstm_cell_ref(*args)
            err = max((c.float() - c_ref.float()).abs().max().item(),
                      (h.float() - h_ref.float()).abs().max().item())
            ok = all(torch.allclose(a.float(), r.float(), rtol=tol, atol=tol)
                     for a, r in ((c, c_ref), (h, h_ref)))
            log(f"[lstm] check {what:16s} B,D,H=({B}, {D}, {H}) {dname:8s}: "
                f"max |kernel - plain| {err:.3e} (tol {tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("lstm_cell disagrees with its plain "
                                     "version")
    w, b, x, c, h = lstm_case(99, 8, 16, 32, torch.float32)
    before = kern.launches
    try:
        kern(w.requires_grad_(), b, x, c, h)
    except RuntimeError as e:
        log(f"[lstm] refuses an operand that requires grad: {e}")
    else:
        raise AssertionError("lstm_cell accepted an operand that requires "
                             "grad")
    if kern.launches != before:
        raise AssertionError("the refused call launched")

    copies = [lstm_case(200 + i, 512, 512, 512, torch.float32)
              for i in range(8)]
    c, h = kern(*copies[0])
    c_ref, h_ref = lstm_cell_ref(*copies[0])
    err = max((c - c_ref).abs().max().item(), (h - h_ref).abs().max().item())
    aten = [aten_lstm_operands(*a) for a in copies]
    h_lib, c_lib = torch.lstm_cell(*aten[0])
    lib_err = max((c_lib - c_ref).abs().max().item(),
                  (h_lib - h_ref).abs().max().item())
    if lib_err > LSTM_TOL["float32"]:
        raise AssertionError(f"torch.lstm_cell yardstick computes another "
                             f"function: {lib_err:.3e}")
    times = call_times(lambda i: kern(*copies[i]), len(copies),
                       lambda i: torch.lstm_cell(*aten[i]), iters=50)
    plain_ms = time_ms(lambda i: lstm_cell_ref(*copies[i]), len(copies),
                       iters=50)
    b_ms, b_by = lstm_bound(*copies[0])
    log(f"[lstm] time lstm_cell at B,D,H=(512, 512, 512) fp32: "
        f"{fmt_times(times, 'torch.lstm_cell')}, plain {plain_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}), max |kernel - plain| {err:.3e}, "
        f"|torch.lstm_cell - plain| {lib_err:.3e}")
    return kernel_record("lstm_cell", err, times, plain_ms, b_ms, b_by)


def instrument_predicate_reads():
    """CUDA events around while_loop's predicate read: event A just
    before the read (the device reaches it when the iteration's work is
    done), event B just after the host has the answer, before it
    enqueues the next iteration. The device is idle from A to B."""
    import importlib
    import torch
    wl = importlib.import_module("repro_torch.core.while_loop")
    holds = wl._holds
    gaps = []

    def timed(pred):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        out = holds(pred)
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        gaps.append((a, b))
        return out

    wl._holds = timed

    def finish():
        wl._holds = holds
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in gaps]
        span = gaps[0][0].elapsed_time(gaps[-1][1]) if gaps else 0.0
        return sum(ms), span, len(ms)

    return finish


def phase_dynamic_rnn():
    """dynamic_rnn inference through the fused cell against the unfused
    cell at B=512, D=H=512, S=1000 (ragged lengths); returns the kernel's
    launches in the fused pass. Then dynamic vs static (Fig. 14)."""
    import functools
    import torch
    from repro_torch import bridge, core
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.models import rnn

    B, S, D, H = 512, 1000, 512, 512
    params = bridge.init_lstm_params(D, H, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, S, D, generator=gen, device="cuda")
    lens = torch.randint(500, S + 1, (B,), generator=gen, device="cuda")
    max_len = int(lens.max())
    fused = functools.partial(rnn.lstm_cell, kernel=lstm_ops.lstm_cell)
    with torch.no_grad():
        # warm-up at full size, so the caching allocator holds the
        # pass's memory before the measured runs
        rnn.dynamic_rnn(params, x, lens, hidden=H, cell=fused)
        torch.cuda.synchronize()
        reads0 = core.while_loop.host_reads
        finish = instrument_predicate_reads()
        lstm_kernel.lstm_cell.launches = 0
        t0 = time.perf_counter()
        out_k, (c_k, h_k) = rnn.dynamic_rnn(params, x, lens, hidden=H,
                                            cell=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lstm_kernel.lstm_cell.launches
        idle_ms, span_ms, n_reads = finish()
        reads = core.while_loop.host_reads - reads0
        t0 = time.perf_counter()
        out, (c, h) = rnn.dynamic_rnn(params, x, lens, hidden=H)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
    if launches != max_len:
        raise AssertionError(f"lstm_cell launched {launches} times for "
                             f"max(lens) = {max_len}")
    err = max((a - r).abs().max().item()
              for a, r in ((out_k, out), (c_k, c), (h_k, h)))
    ok = all(torch.allclose(a, r, rtol=RNN_TOL, atol=RNN_TOL)
             for a, r in ((out_k, out), (c_k, c), (h_k, h)))
    log(f"[rnn] dynamic_rnn B={B} S={S} D=H={H} fp32, lens in [500, {S}], "
        f"max {max_len}: fused cell {wall:.3f} s ({wall / max_len * 1e3:.4f}"
        f" ms/step), unfused cell {wall_plain:.3f} s "
        f"({wall_plain / max_len * 1e3:.4f} ms/step); lstm_cell launches "
        f"{launches}; max |fused - unfused| {err:.3e} (tol {RNN_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[rnn] while_loop host reads: {reads} for {max_len} steps "
        f"({reads / max_len:.3f} per step); device idle at the reads "
        f"{idle_ms / max(n_reads, 1):.4f} ms per read = "
        f"{idle_ms / max(span_ms, 1e-9):.4f} of the loop's device span")
    if not ok:
        raise AssertionError("dynamic_rnn through the fused cell disagrees "
                             "with the unfused cell")
    if out_k[lens.argmin(), max_len - 1].abs().max().item() != 0:
        raise AssertionError("output past a sequence's length is not zero")
    del out, out_k, c, h, c_k, h_k

    # Fig. 14: dynamic_rnn (a counted while_loop; then with full-length
    # seq_lens, which adds the masking and one predicate read per step)
    # against static unrolling, all through the fused cell
    Sf = 500
    for Bf in (8, 32, 128, 512):
        xf = x[:Bf, :Sf].contiguous()
        lf = torch.full((Bf,), Sf, device="cuda")
        runs = {"dynamic": lambda: rnn.dynamic_rnn(params, xf, hidden=H,
                                                   cell=fused),
                "dynamic+lens": lambda: rnn.dynamic_rnn(
                    params, xf, lf, hidden=H, cell=fused),
                "static": lambda: rnn.static_rnn(params, xf, hidden=H,
                                                 cell=fused)}
        times = {}
        with torch.no_grad():
            for name, run in runs.items():
                run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[name] = (time.perf_counter() - t0) / Sf * 1e3
        log(f"[rnn] Fig. 14 B={Bf:3d} S={Sf}: ms/step dynamic "
            f"{times['dynamic']:.4f}, dynamic with seq_lens "
            f"{times['dynamic+lens']:.4f}, static {times['static']:.4f} "
            f"(dynamic / static {times['dynamic'] / times['static']:.3f})")
    return launches


def profile_pass(fn, label, iters):
    """Where one training pass's time goes: the device's busy share of
    the wall time and the top device entries (kernels and copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(r.self_device_time_total for r in rows)
    log(f"[profile] {label}: device busy {dev_us / 1e3:.1f} ms of "
        f"{wall_us / 1e3:.1f} ms wall ({dev_us / wall_us:.3f}), "
        f"{dev_us / iters / 1e3:.4f} ms device time per iteration")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:6]:
        log(f"[profile]   {r.self_device_time_total / 1e3:9.2f} ms "
            f"{r.count:6d}x  {r.key[:70]}")


def phase_policies():
    """Table 1: gradients through dynamic_rnn (unfused cell) under the
    four save policies at B=512, D=H=512, S = 100 and 500."""
    import torch
    from repro_torch import bridge, core
    from repro_torch.core.while_loop import SAVE_POLICIES
    from repro_torch.models import rnn

    B, D, H = 512, 512, 512
    gen = torch.Generator(device="cuda").manual_seed(2)
    for S in (100, 500):
        # full-length sequences, as Table 1 and the JAX package's
        # benchmarks/bench_memory_swap.py run them: a counted loop
        x = torch.randn(B, S, D, generator=gen, device="cuda")
        grads, peaks = {}, {}
        for policy in SAVE_POLICIES:
            params = bridge.init_lstm_params(D, H, seed=3, device="cuda")
            for p in params.values():
                p.requires_grad_()

            def run():
                out, _ = rnn.dynamic_rnn(params, x, hidden=H,
                                         save_policy=policy)
                host = core.while_loop.last_stack.host_bytes
                return torch.autograd.grad((out ** 2).mean(),
                                           [params["w"], params["b"]]), host

            run()                                 # warm-up (pins memory)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g, host = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peaks[policy] = torch.cuda.max_memory_allocated() - base
            grads[policy] = g
            log(f"[policy] S={S} {policy:13s}: {secs / S * 1e3:.4f} ms "
                f"per loop iteration (forward + backward, {S} "
                f"iterations), peak {peaks[policy] / 2**30:.3f} GiB above "
                f"weights and inputs, {host / 2**30:.3f} GiB saved to host")
            if S == 100 and policy in ("all", "offload"):
                profile_pass(run, f"S={S} {policy}", S)
        for policy in SAVE_POLICIES:
            err = max((a - r).abs().max().item()
                      for a, r in zip(grads[policy], grads["all"]))
            ok = all(torch.allclose(a, r, rtol=1e-6, atol=1e-9)
                     for a, r in zip(grads[policy], grads["all"]))
            log(f"[policy] S={S} {policy:13s} gradients vs all: max |diff| "
                f"{err:.3e} (tol rtol 1e-6) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{policy} gradients differ from all's")
        if S == 500 and not (peaks["offload"] < peaks["all"]
                             and peaks["carry"] < peaks["all"]):
            raise AssertionError(f"peak memory order wrong at S=500: "
                                 f"{peaks}")
        del x, grads


def phase_nmt():
    """The NMT example's entry point, 250 steps on the card; it raises if
    the loss does not fall below 0.5."""
    from repro_torch.examples import dynamic_rnn_nmt as nmt
    loss = nmt.main(["--steps", str(nmt.STEPS)])
    log(f"[nmt] {nmt.STEPS} steps on the card: final masked NLL {loss:.4f}"
        f" (bar {nmt.LOSS_BAR})")


def fa_case(seed, B, S, H, KV, D, dtype, T=None):
    """q (B, S, H, D), k and v (B, T, KV, D) drawn on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    T = S if T is None else T
    return [torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


def fa_bound(q, k, v, causal=True):
    """(bound_ms, bound_by): q, k, v read once and o written once over
    HBM bandwidth, against the QK and PV FLOPs of the visible (query,
    key) pairs at the peak rate for the dtype."""
    B, S, H, D = q.shape
    T = k.shape[1]
    pairs = (sum(min(s + 1, T) for s in range(S)) if causal else S * T)
    flops = 4 * D * H * B * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fa_check(out, ref):
    """(max |kernel - plain|, the atol that FA_TOL's rtol leaves this
    case needing, whether it is within FA_TOL)."""
    rtol, atol = FA_TOL[str(ref.dtype).split(".")[1]]
    diff = (out.float() - ref.float()).abs()
    need = (diff - rtol * ref.float().abs()).max().item()
    return diff.max().item(), need, need <= atol


def phase_flash_kernel():
    """The flash-attention kernel against its plain version over the
    JAX sweep and the forward's shape, its autograd refusal, then its
    time at the forward's shape. Returns its record (launches 0: the
    forward phase fills them in)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    kern = fa_kernel.flash_attention
    seed = 0
    for shape in FA_SWEEP + FA_EDGES + (FA_FORWARD,):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for causal in (True, False):
                seed += 1
                args = fa_case(seed, *shape[:5], dtype,
                               T=shape[5] if len(shape) > 5 else None)
                out = kern(*args, causal=causal)
                torch.cuda.synchronize()
                err, need, ok = fa_check(out, attention_ref(*args,
                                                            causal=causal))
                log(f"[flash] check B,S,H,KV,D{',T' * (len(shape) > 5)}="
                    f"{shape} {dname:8s} causal="
                    f"{causal!s:5s}: max |kernel - plain| {err:.3e}, atol "
                    f"needed at rtol {FA_TOL[dname][0]:g}: {need:.3e} (tol "
                    f"{FA_TOL[dname][1]:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("flash_attention disagrees with its "
                                         "plain version")
                del args, out
    q, k, v = fa_case(99, 1, 128, 4, 2, 64, torch.float32)
    before = kern.launches
    try:
        kern(q.requires_grad_(), k, v)
    except RuntimeError as e:
        log(f"[flash] refuses an operand that requires grad: {e}")
    else:
        raise AssertionError("flash_attention accepted an operand that "
                             "requires grad")
    if kern.launches != before:
        raise AssertionError("the refused call launched")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        copies = [fa_case(200 + i, *FA_FORWARD, dtype) for i in range(4)]
        out = kern(*copies[0])
        ref = attention_ref(*copies[0])
        err, need, ok = fa_check(out, ref)
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on the timing copies: {need:.3e}")
        if dtype == torch.float32:
            times = call_times(lambda i: kern(*copies[i]), len(copies),
                               iters=20)
            log(f"[flash] time flash_attention at {FA_FORWARD} fp32: "
                f"{fmt_times(times)}, bound "
                f"{fa_bound(*copies[0])[0]:.4f} ms, max |kernel - plain| "
                f"{err:.3e}")
            continue
        heads = [[t.transpose(1, 2) for t in c] for c in copies]
        lib = sdpa(*heads[0], is_causal=True, enable_gqa=True).transpose(1, 2)
        lib_err, lib_need, lib_ok = fa_check(lib, ref)
        if not lib_ok:
            raise AssertionError(f"the SDPA yardstick computes another "
                                 f"function: {lib_need:.3e}")
        times = call_times(lambda i: kern(*copies[i]), len(copies),
                           lambda i: sdpa(*heads[i], is_causal=True,
                                          enable_gqa=True), iters=20)
        plain_ms = time_ms(lambda i: attention_ref(*copies[i]), len(copies),
                           iters=5)
        b_ms, b_by = fa_bound(*copies[0])
        log(f"[flash] time flash_attention at B,S,H,KV,D={FA_FORWARD} bf16 "
            f"causal: {fmt_times(times)}, plain {plain_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}), max |kernel - plain| {err:.3e} (atol "
            f"needed {need:.3e}), |sdpa - plain| {lib_err:.3e} (atol needed "
            f"{lib_need:.3e})")
        record = kernel_record("flash_attention", err, times, plain_ms,
                               b_ms, b_by)
        del copies, heads, out, ref, lib

    copies = [fa_case(300 + i, *FA_QWEN, torch.bfloat16) for i in range(4)]
    err, need, ok = fa_check(kern(*copies[0]), attention_ref(*copies[0]))
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {FA_QWEN}: {need:.3e}")
    heads = [[t.transpose(1, 2) for t in c] for c in copies]
    times = call_times(lambda i: kern(*copies[i]), len(copies),
                       lambda i: sdpa(*heads[i], is_causal=True,
                                      enable_gqa=True), iters=20)
    b_ms, b_by = fa_bound(*copies[0])
    log(f"[flash] time flash_attention at qwen2-7b's B,S,H,KV,D={FA_QWEN} "
        f"bf16 causal: {fmt_times(times)}; bound {b_ms:.4f} ms ({b_by}), "
        f"device kernel/sdpa {times['ms'] / times['library_ms']:.2f}, max "
        f"|kernel - plain| {err:.3e} (atol needed {need:.3e})")
    del copies, heads
    return record


def forward_batch(cfg):
    """B=4, S=2048 tokens and labels from ``SyntheticLM`` (seed 0), as
    int64 tensors on the card."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    b = SyntheticLM(cfg.vocab, FA_FORWARD[1], FA_FORWARD[0],
                    seed=0).batch_at(0)
    return {k: torch.from_numpy(v).to("cuda", torch.int64)
            for k, v in b.items()}


def timed_forward(params, cfg, batch):
    """(logits, loss, ms of the forward, kernel launches in it)"""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import model_zoo
    with torch.no_grad():
        model_zoo.forward(params, cfg, batch)          # warm-up
        torch.cuda.synchronize()
        fa_kernel.flash_attention.launches = 0
        t0 = time.perf_counter()
        logits, _ = model_zoo.forward(params, cfg, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = fa_kernel.flash_attention.launches
        loss, _ = model_zoo.loss_fn(params, cfg, batch)
    return logits, loss.item(), ms, launches


def route_full(fn):
    """Mode ``full``'s flash path through ``fn(q, k, v, causal=)`` in
    place of ``ops.flash_attention``."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return mock.patch.object(fa_ops, "flash_attention", fn)


def phase_full_forward():
    """llama3.2-1b's full-sequence forward at full width through the
    flash kernel and through chunked attention, in bf16 and in fp32
    compute on the same (bf16-drawn) weights; in bf16 also with each
    layer's kernel call held against the plain version on the same
    operands, and with mode ``full`` routed to the plain version (the
    kernel's rounding points except p's). Returns the kernel's launches
    in the bf16 forward."""
    import dataclasses
    import gc
    import math
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import model_zoo, transformer

    base = get_config("llama3.2-1b")
    batch = forward_batch(base)
    params = bridge.init_params(base, seed=0, device="cuda")
    logits, launches, layer_checks = {}, None, []

    def checked(q, k, v, *, causal=True):
        out = fa_kernel.flash_attention(q, k, v, causal=causal)
        layer_checks.append(fa_check(out, attention_ref(q, k, v,
                                                        causal=causal))
                            + (v.abs().max().item(),))
        return out

    def plain(scale):
        return lambda q, k, v, *, causal=True: (attention_ref(
            q, k, v, causal=causal).float() * scale).to(q.dtype)

    for cdt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        if cdt == "float32":     # the same weights, upcast
            params = pytree.tree_map(lambda t: t.float(), params)
        for impl in ("cuda", "gather"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            path = transformer.resolved_full_attn_impl(c, FA_FORWARD[1],
                                                       "cuda")
            out, loss, ms, n = timed_forward(params, c, batch)
            want = base.n_layers if impl == "cuda" else 0
            log(f"[forward] {cfg.name} {cdt} B,S={FA_FORWARD[:2]} attention "
                f"{path}: {ms:.1f} ms per forward, loss_fn {loss:.4f}, "
                f"flash_attention launches {n} (want {want})")
            if n != want:
                raise AssertionError(f"{path}: {n} kernel launches, want "
                                     f"{want}")
            if not math.isfinite(loss) or out.shape != (
                    *FA_FORWARD[:2], base.padded_vocab):
                raise AssertionError(f"bad loss or logits on {path}")
            if cdt == "bfloat16" and impl == "cuda":
                launches = n
            logits[cdt, impl] = out.float()
            del out
            if cdt == "bfloat16":
                with torch.no_grad():
                    profile_pass(lambda: model_zoo.forward(params, c, batch),
                                 f"one bf16 forward, attention {path}", 1)
        if cdt == "bfloat16":
            c = dataclasses.replace(cfg, attn_impl="cuda")
            for key, fn in (("checked", checked), (1.0, plain(1.0)),
                            (FWD_PERTURB, plain(FWD_PERTURB))):
                with route_full(fn), torch.no_grad():
                    logits[cdt, key] = model_zoo.forward(params, c,
                                                         batch)[0].float()

    err, need, _, vmax = map(max, zip(*layer_checks))
    ok_layers = (len(layer_checks) == base.n_layers
                 and all(r[2] for r in layer_checks))
    log(f"[forward] bf16, each layer's kernel call against the plain version "
        f"on its operands ({len(layer_checks)} layers, max |v| {vmax:.3f}): "
        f"max |kernel - plain| {err:.3e}, atol needed at rtol "
        f"{FA_TOL['bfloat16'][0]:g}: {need:.3e} (tol "
        f"{FA_TOL['bfloat16'][1]:g}) {'ok' if ok_layers else 'FAIL'}")

    def cmp(a, b):
        d = (a - b).abs()
        return (d.max().item(), d.mean().item(),
                (a.argmax(-1) == b.argmax(-1)).float().mean().item())

    err32, _, agree32 = cmp(logits["float32", "cuda"],
                            logits["float32", "gather"])
    ok32 = err32 <= LOGIT_TOL
    log(f"[forward] fp32 logits: max |flash - chunked| {err32:.3e} (tol "
        f"{LOGIT_TOL:g}) {'ok' if ok32 else 'FAIL'}; greedy agreement "
        f"{agree32:.6f}")
    plain16 = logits["bfloat16", 1.0]
    readings = {"flash": cmp(logits["bfloat16", "cuda"], plain16),
                f"plain x{FWD_PERTURB:g}": cmp(logits["bfloat16", FWD_PERTURB],
                                               plain16),
                "chunked": cmp(logits["bfloat16", "gather"], plain16)}
    within = {k: r[0] <= FWD_BF16_TOL["max"] and r[1] <= FWD_BF16_TOL["mean"]
              for k, r in readings.items()}
    for k, (mx, mean, agree) in readings.items():
        log(f"[forward] bf16 logits, {k} against the plain-routed forward: "
            f"max |diff| {mx:.3e}, mean {mean:.3e}, greedy agreement "
            f"{agree:.6f}: {'within' if within[k] else 'outside'} max "
            f"{FWD_BF16_TOL['max']:g}, mean {FWD_BF16_TOL['mean']:g}")
    if not (ok_layers and ok32 and within["flash"]):
        raise AssertionError("the flash path disagrees with its plain "
                             "version in the forward")
    if within[f"plain x{FWD_PERTURB:g}"]:
        raise AssertionError("the bf16 forward gate misses a "
                             f"{FWD_PERTURB - 1:.0%} attention error")
    del params, logits, plain16
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def checkpoint_root(need_bytes):
    """A fresh directory under TMPDIR for the training checkpoints."""
    import shutil
    import tempfile
    free = shutil.disk_usage(tempfile.gettempdir()).free
    log(f"[train] {tempfile.gettempdir()}: {free / 2**30:.1f} GiB free; a "
        f"checkpoint takes {need_bytes / 2**30:.1f} GiB")
    if free < 1.2 * need_bytes:
        raise AssertionError("TMPDIR has no room for the checkpoint")
    return tempfile.mkdtemp(prefix="chip_smoke_ckpt_")


def phase_train():
    """The training launcher at llama3.2-1b full width: falling loss,
    an exact checkpoint, a resume; paper_while + offload against scan;
    the kernel's refusal of training."""
    import dataclasses
    import gc
    import math
    import shutil
    import statistics
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import bridge, core
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    cfg = get_config("llama3.2-1b")
    B, S = FA_FORWARD[:2]
    n_params = model_zoo.count_params(cfg)
    root = checkpoint_root(3 * 4 * n_params)
    argv = ["--arch", cfg.name, "--batch", str(B), "--seq", str(S),
            "--ckpt-dir", root, "--ckpt-every", str(TRAIN_STEPS)]
    try:
        fa_kernel.flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = launch_train.main(argv + ["--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = res["trainer"].history
        losses = [h[1] for h in hist]
        step_ms = [h[2] * 1e3 for h in hist]
        k = TRAIN_STEPS // 4
        first, last = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
        log(f"[train] {cfg.name} ({n_params / 1e9:.3f}B params) fp32 masters, "
            f"{cfg.compute_dtype} compute, remat {cfg.remat}, B={B} S={S}: "
            f"{TRAIN_STEPS} steps in {wall:.1f} s; ms per step median "
            f"{statistics.median(step_ms[1:]):.1f} (first {step_ms[0]:.1f}); "
            f"peak memory {peak / 2**30:.2f} GiB; flash_attention launches "
            f"{fa_kernel.flash_attention.launches}")
        log(f"[train] losses " + " ".join(f"{x:.4f}" for x in losses))
        log(f"[train] mean of the first {k} {first:.4f}, of the last {k} "
            f"{last:.4f}")
        if not all(math.isfinite(x) for x in losses) or not last < first:
            raise AssertionError("the loss is not finite or does not fall")
        if fa_kernel.flash_attention.launches != 0:
            raise AssertionError("training launched the forward-only kernel")

        like = {"params": res["params"], "opt": res["opt"]}
        t0 = time.perf_counter()
        step, state = ck.restore_latest(root, like)
        secs = time.perf_counter() - t0
        same = all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                   for a, b in zip(pytree.tree_leaves(state),
                                   pytree.tree_leaves(like)))
        log(f"[train] checkpoint step {step} restored in {secs:.1f} s: "
            f"{'bit-equal' if same else 'DIFFERS'} to the final state "
            f"({len(pytree.tree_leaves(like))} leaves)")
        if step != TRAIN_STEPS or not same:
            raise AssertionError("the checkpoint does not restore exactly")
        del res, like, state
        gc.collect()
        torch.cuda.empty_cache()

        again = launch_train.main(argv + ["--steps", str(TRAIN_STEPS + 2)])
        resumed = [h[0] for h in again["trainer"].history]
        log(f"[train] second launch resumed at step {again['start']}, ran "
            f"steps {resumed}, losses "
            f"{[round(h[1], 4) for h in again['trainer'].history]}")
        if again["start"] != TRAIN_STEPS or resumed != [TRAIN_STEPS,
                                                         TRAIN_STEPS + 1]:
            raise AssertionError("the second launch did not resume")
        del again
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    params = bridge.init_params(cfg, seed=0, device="cuda",
                                keep_param_dtype=True)
    opt = adamw.init(params)
    batch = SyntheticLM(cfg.vocab, S, B, seed=0).batch_at(0)
    opt_cfg = adamw.AdamWConfig()
    out = {}
    for name, c in (("scan", cfg),
                    ("paper_while+offload", dataclasses.replace(
                        cfg, layer_loop="paper_while",
                        save_policy="offload"))):
        step_fn = train_loop.make_train_step(c, opt_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        ms = (time.perf_counter() - t0) * 1e3
        stack = core.while_loop.last_stack
        host = stack.host_bytes if stack is not None and name != "scan" else 0
        out[name] = (loss, gnorm)
        log(f"[train] one step, layer loop {name}: loss {loss:.6f}, grad norm "
            f"{gnorm:.6f}, {ms:.1f} ms, {host / 2**20:.1f} MiB saved to host")
        if name == "scan":
            profile_pass(lambda: step_fn(params, opt, batch),
                         "one train step (scan, remat full)", 1)
        gc.collect()
    (l0, g0), (l1, g1) = out["scan"], out["paper_while+offload"]
    ok = abs(l1 - l0) <= STEP_LOSS_RTOL * abs(l0)
    log(f"[train] paper_while+offload vs scan: |loss diff| {abs(l1 - l0):.3e}"
        f" (rtol {STEP_LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}, |grad norm "
        f"diff| {abs(g1 - g0):.3e}")
    if not ok:
        raise AssertionError("paper_while+offload and scan disagree")

    # remat at one sequence of the batch (full width; `none` keeps every
    # layer's activations, so B=4 would not leave the 80 GB card room).
    # The step's peak comes in AdamW's update, after the activations are
    # freed, so what remat decides is read after the forward: the bytes
    # the backward holds (the bf16 compute copy included, alike in all).
    one = {k: v[:1] for k, v in batch.items()}
    one_dev = train_loop.batch_to_device(one, "cuda")
    held = {}
    for remat in ("full", "attn_out", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        step_fn = train_loop.make_train_step(c, opt_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new_params, new_opt, m = step_fn(params, opt, one)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        del new_params, new_opt, m
        gc.collect()
        leaves, spec = pytree.tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with torch.enable_grad():
            fwd, metrics = model_zoo.loss_fn(bridge.compute_params(
                pytree.tree_unflatten(live, spec), c), c, one_dev)
            torch.cuda.synchronize()
            held[remat] = (torch.cuda.memory_allocated() - base, loss,
                           fwd.item())
            torch.autograd.grad(fwd, live)
        del fwd, metrics, live
        log(f"[train] one step at B=1, remat {remat}: loss {loss:.6f}, grad "
            f"norm {gnorm:.6f}, {ms:.1f} ms, step peak {peak / 2**30:.3f} "
            f"GiB; held for the backward after the forward "
            f"{held[remat][0] / 2**30:.3f} GiB")
    (h_full, l_full, f_full), (h_attn, l_attn, _), (h_none, l_none, _) = (
        held["full"], held["attn_out"], held["none"])
    ok = (h_full < h_attn < h_none and
          max(abs(l_attn - l_full), abs(l_none - l_full), abs(f_full - l_full))
          <= STEP_LOSS_RTOL * abs(l_full))
    log(f"[train] remat attn_out holds between full and none after the "
        f"forward: {h_full / 2**30:.3f} < {h_attn / 2**30:.3f} < "
        f"{h_none / 2**30:.3f} GiB, one loss: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("remat attn_out: held memory out of order or "
                             "another loss")
    del one, one_dev
    gc.collect()

    step_fn = train_loop.make_train_step(
        dataclasses.replace(cfg, attn_impl="cuda"), opt_cfg)
    try:
        step_fn(params, opt, batch)
    except RuntimeError as e:
        if 'attn_impl="gather"' not in str(e):
            raise
        log(f"[train] a step under attn_impl=\"cuda\" stops at the kernel's"
            f" refusal: {e}")
    else:
        raise AssertionError("a train step ran through the forward-only "
                             "kernel")
    del params, opt


def main() -> int:
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch import kernels  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()

    def timed(phase, *args):
        start = time.perf_counter()
        out = phase(*args)
        log(f"[time] {phase.__name__}: {time.perf_counter() - start:.1f} s")
        return out

    timed(phase_card)
    timed(phase_build)
    records = timed(phase_kernels)
    if sys.argv[1:] == ["--kernels-only"]:
        for phase in (phase_scan_kernel, phase_lstm_kernel,
                      phase_flash_kernel):
            records.append(timed(phase))
        log(json.dumps({"kernels": records}))
        log(f"[done] phases 1-3, 6, 9 and 13 passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    timed(phase_loop_overhead)
    launches = timed(phase_serve)
    timed(phase_parity)
    launches["flash_verify"] = timed(phase_spec_serve)
    timed(phase_spec_parity)
    timed(phase_sampled)
    free_device_memory("the selective-scan phases")
    records.append(timed(phase_scan_kernel))
    free_device_memory("falcon-mamba-7b")
    launches["selective_scan"] = timed(phase_ssm_serve)
    free_device_memory("the fp32 parity run")
    timed(phase_ssm_parity)
    free_device_memory("the LSTM phases")
    records.append(timed(phase_lstm_kernel))
    launches["lstm_cell"] = timed(phase_dynamic_rnn)
    timed(phase_policies)
    timed(phase_nmt)
    free_device_memory("the flash-attention phases")
    records.append(timed(phase_flash_kernel))
    launches["flash_attention"] = timed(phase_full_forward)
    free_device_memory("the training phase")
    timed(phase_train)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
