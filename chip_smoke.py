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
   card, at the llama3.2-1b, qwen2-7b, olmo-1b, smollm-135m,
   internvl2-1b, zamba2-1.2b and whisper-small attention geometries
   (G = 4, 7, 1, 3, 7, 1, 1; KV up to 32, whisper's 12; hd = 64, 128),
   in bf16 and fp32, with
   blocks of 16 and 8, shuffled tables, ``-1`` entries, ragged lengths,
   a ``cur_len = 0`` row (exactly 0), cur_len on the decode kernel's
   partition edges and a chunk running past the table; the chunk
   kernel's ``flash_verify`` entry on speculative windows (W = 2, 5, 8,
   bf16 and fp32, blocks 16 and 8, q_off on the decode kernel's
   partition edges); then each kernel timed at the serving phase's
   shapes (llama3.2-1b, and qwen2-7b for hd 128; the verify entry at
   B = 8, W = 5, q_off 512-568) beside the plain version,
   ``scaled_dot_product_attention`` on the gathered dense layout (a
   yardstick the port never calls) and the bound, and at the MoE, VLM
   and (the decode kernel) hybrid and whisper-small serving geometries
   (whisper's at its own rows: 8 slots at 100-268 positions of 321) as
   extra ``shapes`` of the records;
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
7. serving falcon-mamba-7b at full width and ``SSM_SERVE_LAYERS`` (16)
   of its 64 layers (random weights
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
    them are printed; then each cell under the graph lowering
    (``impl="graph"``: a device counter, device-indexed arrays,
    ``t < max(lens)`` decided on the device), three passes in turns with
    the host pass: one capture, one graph launch a pass, no predicate
    read, max(lens) WHILE-node steps (the fused cell's launches inside
    it), outputs within RNN_TOL of the host lowering's, ms per step both
    ways; then dynamic (counted, and with seq_lens) vs static
    forward time at B = 8, 32, 128, 512 (the paper's Fig. 14; printed,
    not a gate);
11. Table 1: training through the loop (gradients of ``mean(y**2)``
    through ``dynamic_rnn`` with the unfused cell) at B=512, D=H=512,
    S = 100 and 500 under the four save policies: every policy's
    gradients equal ``all``'s, and at S=500 the peak device memory above
    the weights is lower under ``offload`` and ``carry`` than under
    ``all``; time per loop iteration, peak memory and host bytes are
    printed; then the graph lowering (``core.device_grad``: the forward
    and the §5.1 gradient loop as two WHILE nodes) under the four
    policies: gradients equal to the host lowering's ``all`` at rtol
    1e-6, one capture and one launch a loop a pass, ``offload``'s host
    stacks S x ``residual_bytes`` (the body's saved tensors) and
    ``carry_offload``'s S x ``carry_bytes``, at S=500 each offloading
    policy's peak below its device twin's and ``all``'s gradient loop
    (no forward re-run) faster an iteration than ``carry``'s (an
    iteration of each profiled by kernel), and the gradient loop's ms
    per iteration at S=500 within 1.2x of S=100;
    then Fig. 2's ``scan`` (forward and reverse) under the graph
    lowering, ``all`` and ``offload``, equal to the host lowering's
    results and gradients;
12. the NMT example (``repro_torch.examples.dynamic_rnn_nmt``) trains
    250 steps on the card to a loss below 0.5, both loops under the
    graph lowering and its default ``all`` (two captures, four graph
    launches a step); then warm steps under ``carry`` and ``all`` in
    turns (ms a step, host and the launches' device time);
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
    beside SDPA, and at qwen2-moe-a2.7b's (B=4, S=2048, H=KV=16, D=128)
    and zamba2-1.2b's shared block's (B=4, S=2048, H=KV=32, D=64; the
    ``shapes`` entries of its record) beside SDPA and its plain
    version;
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
    finite and fall, and a second launch must resume from the
    checkpoint, its one restore bit for bit the first launch's final
    state (kept on the card meanwhile); one step under
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
    the loop's iterations) is printed against greedy decoding's;
20. (run after phase 19) the prefix cache at llama3.2-1b full width
    (bf16, 8 slots, block 16, chunk 128, a pool of 148 blocks, graph
    segments of at most 8 iterations): 16 requests sharing a 384-token
    system prompt, and 16 drawn from 4 whole prompts, each against the
    same requests with the cache off: every request finishes, both
    kernels launch (counted on the device), nothing gathers, one host
    read a segment, and after the drain the free blocks are the pool
    less the index's pins on the host and on the device; hit blocks,
    evictions, chunk iterations, TTFT and ITL p50/p99 in steps and
    wall, tok/s, peak residents and the copy-on-write's cost a call are
    printed; in fp32 warm streams equal cold ones and the cache-off and
    gather runs' (8/8), and both kernels over a table with 31 shared
    blocks equal their plain versions; at smoke width, speculation (the
    n-gram drafter and the target drafting for itself) with the cache
    on and off gives the non-speculative streams, the self-drafting
    accept rate with hits is within DRAFT_RATE_TOL of the rate without,
    and the accept rates are printed;
21. the SLO scheduler at full width: 12 batch requests holding the 148
    blocks and 4 interactive ones arriving two rounds apart, and the
    same requests uncontended (16 slots): preemptions under overload
    (none uncontended), interactive TTFT p99 in steps below batch's,
    one host read a round at most; per-class p50/p99 TTFT and ITL in
    steps and wall are printed; in fp32 every delivered stream,
    preempted ones included, equals the uninterrupted FIFO run's;
22. ``launch.serve --stream --prefix-cache --hi-every 4`` at full width
    through the streaming front-end (the scheduler stepped on its
    worker thread): 16 requests from 4 prompts arriving eight at a time
    0.1 s apart, so that the second eight find every slot held: every
    stream ends in ``done`` with its tokens, some stream is preempted,
    both kernels launch and nothing gathers;
23. adaptive depth at llama3.2-1b full width (bf16, phase 4's pool and
    16 requests): (a) early exit at threshold inf, an IF node a layer
    in graph segments (``cuda-graph:if-per-layer``) and a read of the
    halt vector a layer in host-read ones, in turns with the
    non-adaptive graph run: streams 16/16 equal to it, mean depth
    exactly 16, the kernels' launches equal to its (and its equal to
    phase 4's) less 16 ``paged_attention`` launches for each decode step
    whose emitting rows all retire, which keeps no layer loop alive
    (counted on the device, ``idle_layer_loops``), one host read a graph
    segment and no predicate read;
    (b) exit by construction: ``wo`` and ``w_down`` zeroed from layer 2
    on, threshold -1 and a floor of 2: streams 16/16 equal to the same
    doctored model's non-adaptive run, mean depth exactly 2, and
    ``paged_attention`` launches (counted on the device) exactly 2/16 of
    that run's for the decode steps with a live row (none for those
    whose emitting rows all retire) with ``flash_prefill`` unchanged (the port of the JAX
    package's ``check_depth_gating``); (c) mixture-of-depths (capacity
    0.5, every 2, zero routers) in fp32 on 8 requests: graph segments,
    host-read segments and ``engine.generate_batch_sync`` give identical
    streams; (d) printed: tok/s and device ms an iteration of every
    run, ``exit_margin``'s device ms at B=8 beside its byte bound, what
    remains of inf's extra time after its 16 margins, and the mean depth
    at thresholds 0.05, 0.2 and 0.8, each beside the card's name and
    power limit;
24. (run after phase 12) the paper's §6.5 DQN
    (``examples.dqn_in_graph.dqn_rows``): the same 200 steps from the
    same carry in-graph (a: ``while_loop(impl="graph")``, its three
    conditionals IF nodes), out-of-graph (b: a host loop of one captured
    step a launch) and eager (c: native conditionals, three predicate
    reads a step), in turns a, b, c, c, b, a: host and device us a step,
    graph and kernel launches and host reads a step, (b)/(a) - 1 beside
    the paper's 21% and (c)/(a) are printed; (a) must be one launch and
    no host read, and the final carries of (a) and (b) must equal (c)'s
    (the key, ``t`` and the actions exactly, floats within DQN_TOL); then
    the example's ``main`` (2,000 training steps in one launch) must
    improve the return;
25. the examples: ``quickstart`` on the card equal to its CPU run within
    QUICK_TOL; ``train_lm --full`` (smollm-135m at its published width)
    20 steps through the Trainer and 20 as two in-graph loops of 10, the
    loss finite and falling, ms a step printed; ``elastic_restart``
    phases 1-2 at that width within 1e-5 (whether exactly 0 is printed;
    its phase 3, 8 gloo CPU ranks, runs in the CPU tests);
26. (run after phase 23) prefill/decode disaggregation at llama3.2-1b
    full width (bf16): ``bench_disagg``'s mix (32 requests, 7 prompts of
    8 tokens to 1 of 512, budgets 6-22, EOS -1; block 16, chunk 128,
    segments of 8) through a 2-slot prefill tier and an 8-slot decode
    tier against the colocated 8-slot scheduler, in turns (colocated,
    disaggregated twice, colocated): every request finishes, nothing
    gathers, each tier (and the colocated pool) makes one host read a
    segment and drains, ``paged_attention`` launches on the decode tier
    and ``flash_prefill`` on the prefill tier; tok/s, the running-slot
    inter-token gap p50/p99 (``bench_disagg``'s round accounting),
    shipments, bytes, the export's device us, host reads a round and
    launches per tier, and how long the two tiers' segments were in
    flight at once are printed; in fp32 the disaggregated streams must
    equal the colocated ones 32/32, and a decode tier held full by two
    batch-class requests must preempt one for an urgent arrival with no
    replay mismatch, every stream equal to the uncontended run's;
27. (run after phase 26) qwen2-moe-a2.7b at full width and
    ``MOE_SERVE_LAYERS`` (12) of its 24 layers (60 experts top-4 and 4
    shared, bf16, random weights from a seed,
    ``attn_impl="cuda"``) through the chunked paged pool of phase 4 (8
    slots, block 16, chunk 128): 16 requests of exactly 512 tokens, 64
    new each, EOS -1, graph and host-read segments in turns as in phase
    4 (the MoE's sort-based routing inside the captured segment): every
    request finishes, both block-table kernels launch and the gather
    path never runs, one host read a graph segment, launches equal
    across lowerings; tok/s, the device's share of the wall in segments,
    device ms an iteration, host reads a segment and peak memory are
    printed, then a decode-only segment's device ms an iteration at 8
    running slots beside the bytes bound of the reference's MoE (every
    expert's weights read every iteration; predicted 8.5 ms) and beside
    the top-4 share of the expert bytes;
28. the same model cut to 4 layers in fp32: the 16 requests through the
    kernels in graph segments and through the gather path in host-read
    segments must give identical greedy streams 16/16; the routed
    entries dropped for capacity (decode and prefill groups) are
    printed, counted from the routing maps of the host-read run's MoE
    calls and read once after it; ``model_zoo.forward`` and ``loss_fn``
    at B=1, S=512 through the flash kernel (G = 1, D = 128, one launch a
    layer) must agree with chunked attention (logits within LOGIT_TOL,
    the loss and its aux terms within MOE_LOSS_RTOL);
29. internvl2-1b at full width (bf16, ``attn_impl="cuda"``) through the
    chunked paged pool with its patch prefix (``prefix_len`` 256) and the
    prefix cache on and off, in graph segments: 16 requests of 256
    seeded random patch embeddings and a 256-token prompt, 4 images each
    shown to 4 requests behind one 64-token system text: every request
    finishes, both kernels launch and nothing gathers, one host read a
    segment, the cache hits and the drain leaves only its pins; one
    prompt with two images never hits; hit blocks, chunk iterations and
    tok/s are printed, on against off; then at 4 layers in fp32 the
    kernel path with the prefix cache must give the gather path's
    streams without it, 16/16;
30. (run last) training the MoE and VLM families: internvl2-1b at full
    width through ``launch.train.main`` (B=4, S=1024 behind 256 patch
    embeddings, lr 1e-3, 12 steps, a checkpoint at step 8): the loss
    finite and falling, and a second launch resuming at 8 reruns steps
    8-11, the first of them with the first launch's loss bit for bit and
    the rest within RESUME_RTOL; qwen2-moe-a2.7b at full width
    and 2 layers (``MOE_TRAIN_LAYERS``: 4 do not fit the card) through
    ``make_train_step`` (B=2, S=512, 6 steps): the loss finite and
    falling, both aux terms finite, every layer's router gradient
    non-zero; ms a step and peak memory printed; no flash launch;
31. (run after phase 29) adaptive depth on qwen2-moe-a2.7b and
    internvl2-1b at full width (bf16, the pools of phases 27 and 29
    without the prefix cache, graph segments; qwen2-moe at
    ``MOE_SERVE_LAYERS`` layers, internvl2 at its 24): threshold inf
    gives the non-adaptive streams bit for bit (16/16, in turns), mean
    depth exactly the layer count L and equal launches but L for each
    decode step whose emitting rows all retire; exit by
    construction at layer 2 (an identity tail; the MoE's expert and
    shared ``w_down`` zeroed) launches exactly 2/L of the doctored
    non-adaptive run's ``paged_attention`` over the decode steps with a
    live row, streams equal;
    mixture-of-depths (zero routers) runs with depth L; one host read a
    graph segment; tok/s and device
    ms an iteration against the non-adaptive run printed; then at 4
    layers in fp32, early exit at inf and mixture-of-depths on, the
    kernel path in graph and host-read segments and the gather path
    give one set of streams (8/8);
32. (run after phase 8) zamba2-1.2b at full width (38 mamba2 layers,
    one shared attention block applied 7 times; bf16, random weights
    from a seed, ``attn_impl="cuda"``) through one-shot admission: 16
    requests of exactly 512 tokens, 64 new each, in graph and host-read
    segments in turns as in phase 4: every request finishes, one host
    read a graph segment, ``paged_attention`` launches equal across
    lowerings at 7 a decode iteration, no gather; tok/s, a decode-only
    segment's device ms an iteration at 8 slots beside its bytes bound
    (predicted 1.1 ms) and an admission's device ms printed; then at 12
    layers (2 applications) in fp32 the kernel path in graph and
    host-read segments and the gather path give one set of streams;
33. (run after phase 32) whisper-small at full width (12 encoder and
    12 decoder layers, d_model 768, 12 heads of 64, vocab 51865, 1500
    stub frames; bf16, random weights and frames from a seed,
    ``attn_impl="cuda"``, the paged self cache in blocks of 16) through
    one-shot admission: 16 requests of 4-192 tokens drawn from the seed,
    128 new each, on 8 slots, in graph and host-read segments in turns
    as in phase 4: every request finishes, one host read a graph
    segment, ``paged_attention`` launches equal across lowerings at 12 a
    decode iteration, the gather path never runs on the self cache;
    tok/s each way and the device-busy share, an admission's device ms
    (the encoder's part apart) and a decode-only segment's device ms an
    iteration at 8 slots beside its bytes bound
    (``encdec_decode_bytes``) printed;
34. the same at 4 + 4 layers in fp32: the kernel path in graph and
    host-read segments and the gather path give one set of greedy
    streams (8/8); ``engine.prefill_chunk`` over a paged cache through
    the flash-prefill kernel gives the one-shot prefill's logits within
    LOGIT_TOL at every real position;
35. (run last) training the audio family and the hybrid through
    ``launch.train.main`` at full width: whisper-small at B=8, S=448 (its
    ``max_target_len``) behind 1500 frames, 12 steps with a checkpoint at
    8: the loss finite and falling (mean of the first 3 against the last
    3, as phase 30) and the resume exact; zamba2-1.2b (38 layers,
    ``remat="full"``) at B=2, S=2048 (``ZAMBA_TRAIN_BATCH``: B=4 does not
    fit the card), 8 steps: the loss finite and falling; ms a step and
    peak memory printed.

36. (run after phase 35) smollm-135m at full width (30 layers, d_model
    576, vocab 49152, fp32 compute) on a (1, 1, 1) data x model x stage
    ``DeviceMesh`` on the card: NCCL at world size 1, initialised through
    ``launch.distributed`` (a ``FileStore`` in a temporary directory) and
    built through ``launch.mesh``; one train step at B=4, S=512 with
    ``rules=make_rules(cfg, mesh)`` and the masters and AdamW moments as
    DTensors placed by ``logical_to_sharding(param_axes(cfg), rules)``,
    against the single-device step on the same batch: the loss to 1e-5
    relative, every updated leaf to 1e-5 (2 x lr where the leaf's
    gradient is below 1e-4 of its largest, as the fp32 train tests hold
    it); a second step keeps every leaf placed; the backend, the world
    size and three leaves' placements printed;
37. the same width off the mesh: ``accum="pipeline"``,
    ``accum_stages=4``, ``grad_accum=4`` at B=16, S=128 against
    ``accum="fori"`` on the same batch within 36's tolerance; the
    schedule's step count (M + S - 1 = 7), its ms a step (CUDA events
    around the train step, over the 7 steps) and the peak memory
    printed beside the bytes the schedule's fp32 trees were reckoned at;
38. ``dist.pipeline.distributed_while`` off the mesh, with and without
    its barrier, against ``x * 1.0001 ** 50``; a counted loop of 1001
    ``tanh(x @ w)`` bodies under ``impl="graph"`` with
    ``parallel_iterations=4``: bit for bit the carry of
    ``parallel_iterations=1``, in ceil(1001 / 4) = 251 loop steps (250
    WHILE-node iterations of 4 bodies, then a remainder step of 1 after
    the WHILE node) against 1001 (read from the graph's device
    counter), each replay timed;
39. (run after phase 26) phase 4's pool and requests (llama3.2-1b full
    width, bf16) through ``DecodeScheduler(rules=, mesh=)`` on a (1,)
    data mesh over NCCL at world size 1, against the mesh-less
    scheduler: the streams bit for bit, both ``cuda-graph:while``, the
    pool "single", the same device launch counts; tok/s of both printed;
40. phase 26's disaggregation on disjoint slices: two ranks spawned on
    ``cuda:0`` (``launch.distributed.run_local``; NCCL refuses two ranks
    on one card, so gloo over a ``FileStore``), split 1 + 1
    (``carve_slices(1)``), llama3.2-1b full width on phase 26's mix, each
    rank drawing its own weights: every request finishes, 32 transfers,
    ``paged_attention`` launched on the decode rank and
    ``flash_prefill`` on the prefill rank, nothing gathers, both pools
    drain; in fp32 the streams equal phase 26's colocated fp32 streams
    32/32; tok/s, the bytes and the transfer ms p50/p99 (the decode
    rank's host wall of each shipment's broadcasts) printed beside phase
    26's figures. The two ranks time-share the card: this is the
    split's cost on one card, not multi-device speed;
41. (run after phase 38) ``launch.train --mesh 1,1,1 --ckpt-dir`` at
    smollm-135m full width (fp32 masters, B=8, S=256) on NCCL at world
    size 1: 4 steps checkpointed at 2 and 4; with step 4's checkpoint
    removed, a fresh launch resumes at 2, and its parameters at step 4
    equal the uninterrupted run's bit for bit (deterministic algorithms
    on for the phase: the embedding's backward adds its rows in one
    order);
42. (run last) the model axis in the training step: qwen2-moe-a2.7b at
    full width and ``MOE_TRAIN_LAYERS`` layers in fp32 compute (B=2,
    S=512, phase 30's shapes) on a (1, 2) data x model mesh of two ranks
    spawned on ``cuda:0`` and joined by gloo, as phase 40's (its 60
    experts and padded vocab of 152064 split 2 ways: ``EXPERT`` binds, so
    each rank holds 30 experts, and the vocab-parallel cross entropy
    runs on 76032 columns a rank), against the one-rank step run first
    in this process and freed before the ranks start: the loss to 1e-5
    relative, the gradient norm to 1e-4, the updated router, expert and
    unembedding leaves by ``step_gap``'s rule, each rank's local
    ``w_gate`` (30, 2048, 1408) a layer and 76032 unembedding columns,
    in the masters and inside the expert computation and the CE (the
    gate that no weight is whole; ``sharding.COUNTS["whole_gathers"]``,
    the weights handed to them whole, reads 0); per rank its peak GiB
    beside the one-rank step's, its expert bytes and the wall of two
    steps printed, with the collectives gloo carries through host memory
    (``launch.distributed.STAGED``). The ranks time-share the card over
    gloo's host path: the wall is the schedule's cost on one card, not
    multi-device speed;
43. (run last) the model axis in serving: llama3.2-1b at full width (16
    layers, 32/8 heads) in fp32 compute, ``attn_impl="cuda"``, through
    ``DecodeScheduler(rules=, mesh=)`` on a (1, 2) data x model mesh of
    two gloo ranks on ``cuda:0`` (spawned as phase 42's), each rank on
    its slices of the weights (``sharding.serve_slices``: 16 query and 4
    K/V heads, half the MLP's columns and of the vocabulary) and its 4
    K/V heads of the pool: 8 slots, paged, block 16, chunked (128), 8
    prompts of 512 tokens, 32 new tokens each, greedy; against the
    one-rank scheduler (host-read segments, run first in this process
    and freed before the ranks start). Gates: the streams equal (where
    one diverges, the one-rank run's top-2 logit gap at that token,
    printed, must be under 1e-4 relative); ``COUNTS["whole_gathers"] ==
    0``; each rank's parameter and K/V bytes half the one-rank pool's
    (within 2%); each rank launches ``paged_attention`` and
    ``flash_prefill`` on 16/4 local heads, counted from 0 just before
    the run. Tok/s of both runs is printed: two gloo ranks time-sharing
    one card, not multi-device speed. Phase 3 also holds both block-table
    kernels (and the verify entry) to their plain versions at every
    ``q_head0`` of internvl2-1b's 14/2 heads split 7 ways (the
    ``q_head0`` path of a model axis that splits the query heads and not
    the K/V heads), bf16 and fp32, and times the straddling range;
44. (run last) the model axis in serving for the SSM, hybrid and audio
    families: falcon-mamba-7b (8 of 64 layers: the scan kernel on 4096
    of the 8192 channels), zamba2-1.2b (12 of 38 layers: 32 of the 64
    mixer heads, 16/16 of the shared block's heads) and whisper-small
    (4 + 4 of 12 + 12 layers: 6/6 heads, half the MLP, 1500 frames) at
    full width in fp32 through ``DecodeScheduler(rules=, mesh=)`` on a
    (1, 2) data x model mesh of two gloo ranks on ``cuda:0`` (spawned as
    phase 42's; one launch serves the three in turn), each rank on its
    slices of the weights and of the SSM state, K/V pool and cross K/V:
    4 slots, one-shot, 4 requests of 256 tokens (whisper 4-192), 16 new
    each, greedy, every pool warmed by one short request before its
    timed run; against the one-rank scheduler (host-read, run first in
    this process for each family and freed before the ranks start).
    Gates, each family on each rank: the streams equal (where one
    diverges, the one-rank run's top-2 gap there under 1e-4 relative);
    ``COUNTS["whole_gathers"] == 0`` and split all-reduces made;
    ``model_layout`` "split:modelx2"; the parameter bytes and each cache
    part's bytes exactly what the rules give (an even half of each split
    leaf and part; mamba2's B and C parts, its conv window's B and C
    channels, the norms, its per-head scalars and whisper's ``b_out``
    whole); ``selective_scan`` (falcon-mamba) or ``paged_attention``
    (zamba2, whisper) launched, counted from 0 just before the run, and
    no ``PagedView.gather``. Tok/s of both runs, the bytes and the counts
    are printed: two gloo ranks time-sharing one card, not multi-device
    speed.
45. (run after phase 11) §5.1's gradient of a cond on the device: Table
    1's LSTM (B=512, D=H=512, S=500, fp32, unfused cell) run only where
    a seeded flag is set (about 50%), ``cond(flags.read(t) != 0, step,
    carry through, backend="graph")`` in a counted graph loop, under the
    four graph policies: w, b and x gradients equal to the host
    lowering's (``backend="native"``, ``all``) at rtol 1e-5, two graph
    launches a pass and no host read added by a pass; ms an iteration at
    50% flags, and under ``all`` and ``carry`` at 100% (the captured
    loop replayed with the flags reloaded); then the JAX test's program
    ``cond(i % 2 == 0, y * w, y + 1)`` under ``carry`` against its
    closed form;
46. a graph loop in a graph loop: an outer ``while_loop(impl="graph")``
    over 4 stacked LSTM layers (weights (4, 1024, 2048) read at the outer
    counter) whose body runs ``dynamic_rnn(impl="graph")`` through the
    fused cell at B=512, S=1000: bit-equal to
    ``multilayer_dynamic_rnn(impl="graph")`` (a graph loop a layer), one
    graph launch a pass, 4,000 ``lstm_cell`` launches counted on the
    device; then under grad, 2 layers at S=100 with the outer loop under
    ``carry`` and the layers' loops under each policy: gradients equal
    to ``impl="host"``'s at rtol 1e-5, two graph launches a pass.

llama3.2-1b's bf16 weights (``attn_impl="cuda"``) are drawn once for
phases 4, 17, 19, 20, 26 and 39 and freed after 39; phase 40's ranks
draw their own. falcon-mamba's are made (phase 23 frees its own before the
next), phases 27-35 make and free their own, and
falcon-mamba's are freed before the LSTM phases, and each of the last
phases frees what it made. Then
one JSON line of kernel records (``paged_attention`` and
``flash_prefill`` also give ``path_launches``: their launches in each
serving path's first graph run, llama3.2-1b, qwen2-moe-a2.7b,
internvl2-1b, both early-exit runs at inf, zamba2-1.2b and
whisper-small, the counts set to 0 just before it, and the rank 0 of
phase 43 and of each of phase 44's three paths, where
``selective_scan`` also gives its launches on those three) and, last, the
device line. Any
failed check raises, so the script exits non-zero and prints no result;
it also exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
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
              ("olmo-1b", 16, 16, 128), ("smollm-135m", 9, 3, 64),
              ("internvl2-1b", 14, 2, 64), ("zamba2-1.2b", 32, 32, 64),
              ("whisper-small", 12, 12, 64))
# the MoE and VLM serving phases' attention geometries (qwen2-moe-a2.7b's
# MHA is olmo-1b's): the block-table kernels are timed there too, as
# extra ``shapes`` of their records
NEW_SHAPES = (("qwen2-moe-a2.7b", 16, 16, 128), ("internvl2-1b", 14, 2, 64))
# the hybrid's shared attention block (decode only: it prefills one-shot)
HYBRID_SHAPE = ("zamba2-1.2b", 32, 32, 64)
# whisper-small's decoder self-attention (decode only in serving: the
# scheduler admits the audio family one-shot)
WHISPER_SHAPE = ("whisper-small", 12, 12, 64)
# its serving phase's decode rows: prompts of 4-192 tokens part way into
# 128 new ones (max_len 192 + 128 + 1)
WHISPER_LENS, WHISPER_MAX_LEN = [100 + 24 * i for i in range(8)], 321
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
SSM_SERVE_LAYERS = 16   # phases 7-8: falcon-mamba-7b's depth, cut from 64
#                         (to 32 as phases 30-32 joined, to 16 as phases
#                         33-35 did) to keep the script under 900 s (a
#                         layer's work is the same at any depth)
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
            (2, 128, 8, 2, 8),           # the smoke llama's head dim,
            (1, 256, 16, 16, 128))       # and qwen2-moe-a2.7b's MHA
FA_FORWARD = (4, 2048, 32, 8, 64)        # the llama3.2-1b forward's shape
FA_QWEN = (4, 2048, 28, 4, 128)          # qwen2-7b's geometry, timed beside
FA_MOE = (4, 2048, 16, 16, 128)          # qwen2-moe-a2.7b's (G = 1), likewise
FA_ZAMBA = (4, 2048, 32, 32, 64)         # zamba2-1.2b's shared block (G = 1)
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
DQN_TOL = 1e-5      # in-graph against eager DQN carries after 200 steps: the
#                     same kernels, the branch outputs copied; the parity
#                     test's bound for a carry on the card
QUICK_TOL = 1e-6    # quickstart's values on the card against the CPU: fp32
#                     scalars through tanh, sin and products
DRAFT_RATE_TOL = 0.02   # phase 20: the self-drafting accept rate with prefix
#                         hits against without (equal on the CPU; the
#                         draft's hit positions are prefilled in one call
#                         there, in chunks without hits)
MOE_PARITY_LAYERS = 4    # phase 28 and phase 29's fp32 runs: full width,
#                          depth cut to 4 layers
MOE_SERVE_LAYERS = 12    # phases 27 and 31: qwen2-moe-a2.7b's depth, cut
#                          from 24 to keep the script under 900 s as phases
#                          33-35 joined it (a layer's work is the same)
MOE_LOSS_RTOL = 1e-5     # fp32 aux losses through flash and chunked attention
VLM_IMAGES = 4           # phase 29: images, each shared by 4 requests
VLM_SYSTEM = 64          # tokens of the system text behind every image
MOE_TRAIN_LAYERS = 2     # phase 30: qwen2-moe-a2.7b's depth in training.
#   At 4 layers its 2.91 B fp32 masters are 11.6 GB a tree; the step holds
#   the masters, both moments, the gradients and the new masters and
#   moments at once (7 trees, 81 GB) and cannot fit the 80 GB card
TRAIN_FAMILY_STEPS = 12  # phase 30: internvl2-1b launcher steps
TRAIN_FAMILY_CKPT = 8    # phase 30: its checkpoint; the resume reruns 8-11
TRAIN_FAMILY_LR = 1e-3   # phase 30: at the launcher's 3e-4, 12 steps move a
#                          loss of about 12.1 by only 0.015
MOE_TRAIN_STEPS = 6      # phase 30: qwen2-moe-a2.7b train steps
RESUME_RTOL = 1e-3       # phase 30: resumed steps after the first (whose
#                          loss must be bit-equal) against the first
#                          launch's: bf16 steps whose embedding gradient
#                          is summed by atomic adds in any order
HYBRID_PARITY_LAYERS = 12   # phase 32's fp32 runs: 2 shared-block apps
WHISPER_PROMPT = 192     # phases 33-34: the longest prompt (4-192 tokens)
WHISPER_NEW = 128        # phases 33-34: new tokens a request
WHISPER_PARITY_LAYERS = 4   # phase 34: encoder and decoder depth in fp32
WHISPER_CHUNK = 64       # phase 34: prefill_chunk's chunk
WHISPER_TRAIN_STEPS = 12    # phase 35: whisper-small launcher steps
WHISPER_TRAIN_CKPT = 8      # phase 35: its checkpoint; the resume reruns 8-11
WHISPER_TRAIN_LR = 1e-4     # phase 35: at 1e-3 the loss rose after step 2
#                             (11.02 -> 11.06, means of 3); at 3e-4 and 1e-4
#                             it fell by 0.011 and 0.016 on the H100
ZAMBA_TRAIN_BATCH = 2       # phase 35: zamba2-1.2b's batch at S=2048. B=4
#   runs out of the 80 GB (77.96 GiB allocated when it failed): seven fp32
#   trees of 1.17 B parameters and the shared block's seven applications
#   outside the remat, each keeping its chunked attention's fp32 scores
ZAMBA_TRAIN_STEPS = 8       # phase 35: zamba2-1.2b launcher steps
MESH_BATCH = (4, 512)       # phase 36: B, S of the smollm-135m mesh step
MESH_LR = 1e-3              # phases 36-37: AdamW's rate, constant
PIPE_BATCH = (16, 128)      # phase 37: 4 microbatches x 4 stage chunks of
#                             one row each
PIPE_STAGES = 4             # phase 37: accum_stages (and grad_accum)
EP_MESH = (1, 2)            # phase 42: data x model, two gloo ranks
EP_BATCH = (2, 512)         # phase 42: phase 30's B, S
MODEL_MESH = (1, 2)          # phase 43: data x model, two gloo ranks
MODEL_SERVE = (8, 512, 32)   # phase 43: requests, prompt tokens, new tokens
MODEL_GAP = 1e-4             # phase 43: a diverging stream's top-2 gap bound
FAMILY_MESH = (1, 2)         # phase 44: data x model, two gloo ranks
FAMILY_SERVE = (4, 256, 16)  # phase 44: requests, prompt tokens, new tokens
FAMILY_LAYERS = {            # phase 44's depths, cut for time (PERF.md §4)
    "falcon-mamba-7b": 8,            # of 64
    "zamba2-1.2b": 12,               # of 38, as phase 32's fp32 runs
    "whisper-small": 4}              # of 12 + 12, as phase 34
HEAD_SPLIT = (14, 2, 64, 7)  # phase 3: internvl2-1b's H, KV, hd over 7 ranks
EP_LEAVES = (("layers", "moe", "router"), ("layers", "moe", "w_gate"),
             ("layers", "moe", "w_up"), ("layers", "moe", "w_down"),
             ("unembed",))  # phase 42: the updated leaves held to one rank's
WINDOW_ITERS = 1001         # phase 38: a counted loop whose window of 4
#                             leaves a remainder step of 1
LOOP_WINDOW = 4             # phase 38: parallel_iterations


def log(msg: str) -> None:
    print(msg, flush=True)


def profile_rows(prof):
    """``profile_rows(prof)``'s rows, as far as this script reads them
    (``key``, ``count``, ``device_type`` and, for a device event,
    ``self_device_time_total`` in us), summed from the profiler's raw
    events. ``key_averages`` first builds a Python event tree with
    memory attribution, which took about a minute for a profiled
    host-read serving run of 8 requests on the H100 (about 700,000
    events), ten times the run: the profiled runs' set-up, not their
    figures."""
    import types
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    agg = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or e.is_hidden_event():
            continue
        dt = e.device_type()
        row = agg.get((name, dt))
        if row is None:
            row = agg[(name, dt)] = types.SimpleNamespace(
                key=name, count=0, device_type=dt,
                self_device_time_total=0.0)
        row.count += 1
        if dt != DeviceType.CPU:
            row.self_device_time_total += e.duration_ns() / 1e3
    return list(agg.values())


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


def time_block_table(kind, name, geom, fns, lens=None, max_len=577):
    """One block-table kernel at the serving phase's shapes for the
    attention geometry ``geom``: 8 slots, 512-token prompts, block 16,
    37 blocks per row; decode rows mid-generation, prefill rows at the
    four chunk offsets of a 512-token prompt with 128-token chunks,
    verify windows (W = 5, speculation's k = 4) at q_off 512-568 (or the
    rows' ``lens`` in a table of ``max_len`` positions). Times the
    kernel and SDPA on the gathered dense layout over 8 operand copies
    (``call_times``: device and eager), and the plain version eagerly.
    Returns its record (launches 0)."""
    import torch
    arch, H, KV, hd = geom
    main_lens = {"decode": [513 + 8 * i for i in range(8)],
                 "prefill": [0, 128, 256, 384] * 2,
                 "verify": [512 + 8 * i for i in range(8)]}
    if lens is not None:
        main_lens[kind] = lens
    kern, plain = fns[kind]
    C = VERIFY_W if kind == "verify" else 128
    shape = "decode" if kind == "decode" else "prefill"
    copies = [make_case(shape, 100 + i, H, KV, hd, torch.bfloat16,
                        main_lens[kind], max_len=max_len, C=C)
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


def check_head_ranges(fns):
    """Both block-table kernels and the verify entry at every ``q_head0``
    of internvl2-1b's 14/2 heads split 7 ways (``HEAD_SPLIT``: two query
    heads a rank against both K/V heads; ranks 3's heads 6-7 straddle the
    two), bf16 and fp32, ragged lengths: each rank's call against the
    plain version on its heads, and that against the whole call's heads.
    Then the straddling range and the whole call timed at the serving
    phase's shapes in bf16 (device time, CUDA-graph replays). Returns
    ``{kind: {...}}`` for the records."""
    import torch
    H, KV, hd, m = HEAD_SPLIT
    n = H // m
    lens = {"decode": [0, 1, 63, 64, 65, 500, 1999, 2048],
            "prefill": [0, 1, 5, 128, 300, 1000, 1900, 2048 - 64],
            "verify": [0, 63, 64, 65, 127, 500, 1000, 2040]}
    serving = {"decode": [513 + 8 * i for i in range(8)],
               "prefill": [0, 128, 256, 384] * 2,
               "verify": [512 + 8 * i for i in range(8)]}
    out, seed = {}, 700
    for kind in ("decode", "prefill", "verify"):
        kern, plain = fns[kind]
        shape = "decode" if kind == "decode" else "prefill"
        C = VERIFY_W if kind == "verify" else 128
        worst = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            seed += 1
            q, *rest = make_case(shape, seed, H, KV, hd, dtype, lens[kind],
                                 C=C)
            whole = plain(q, *rest)
            errs, ok = [], True
            for r in range(m):
                heads = slice(r * n, (r + 1) * n)
                ql = q[:, :, heads].contiguous()
                got = kern(ql, *rest, q_head0=r * n, n_heads=H)
                torch.cuda.synchronize()
                ref = plain(ql, *rest, q_head0=r * n, n_heads=H)
                errs.append((got.float() - ref.float()).abs().max().item())
                ok = ok and torch.allclose(got.float(), ref.float(),
                                           atol=TOL[dname], rtol=TOL[dname])
                ok = ok and torch.allclose(ref.float(),
                                           whole[:, :, heads].float(),
                                           atol=TOL[dname], rtol=TOL[dname])
            worst = max(worst, max(errs))
            log(f"[kernels] check {kind:7s} head ranges H={H} KV={KV} "
                f"hd={hd} over {m} ranks ({n} heads from q_head0 "
                f"{', '.join(str(r * n) for r in range(m))}) {dname:8s}: "
                f"max |kernel - plain| per rank "
                f"{', '.join(f'{e:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} disagrees with its plain "
                                     f"version on a head range")
        copies = [make_case(shape, 800 + i, H, KV, hd, torch.bfloat16,
                            serving[kind], max_len=577, C=C)
                  for i in range(8)]
        r = m // 2
        local = [c[0][:, :, r * n:(r + 1) * n].contiguous() for c in copies]
        at = dict(q_head0=r * n, n_heads=H)
        ms_range = graph_ms(lambda i: kern(local[i], *copies[i][1:], **at),
                            8)
        ms_whole = graph_ms(lambda i: kern(*copies[i]), 8)
        plain_ms = time_ms(lambda i: plain(local[i], *copies[i][1:], **at),
                           8, iters=10)
        # the library yardstick: SDPA on the range's heads, K/V repeated
        # to every query head (sdpa_operands) and cut to the range
        heads = slice(r * n, (r + 1) * n)
        dense = [tuple(t[:, heads].contiguous() for t in d[:3]) + d[3:]
                 for d in (sdpa_operands(shape, *c) for c in copies)]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = graph_ms(lambda i: sdpa(dense[i][0], dense[i][1],
                                         dense[i][2], attn_mask=dense[i][3]),
                          8)
        b_ms, b_by = bound(shape, local[0], *copies[0][1:])
        log(f"[kernels] time {kind} head range {r * n}-{(r + 1) * n - 1} "
            f"of {H} (K/V heads {r * n // (H // KV)}-"
            f"{((r + 1) * n - 1) // (H // KV)}) at serving shapes, bf16, "
            f"q {tuple(local[0].shape)}: device {ms_range:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, plain (eager) {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); the whole {H}-head call "
            f"{ms_whole:.4f} ms")
        out[kind] = {"H": H, "KV": KV, "hd": hd, "ranks": m,
                     "max_abs_err": worst, "range_ms": ms_range,
                     "whole_ms": ms_whole, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
    return out


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
    # the MoE, VLM, hybrid and audio serving geometries: extra records of
    # the same kernels (the hybrid's shared block and whisper's decoder
    # decode only); whisper's at its own serving lengths
    for rec, kind in zip(records, ("decode", "prefill")):
        rec["shapes"] = []
        for geom in NEW_SHAPES + ((HYBRID_SHAPE, WHISPER_SHAPE)
                                  if kind == "decode" else ()):
            at = ({"lens": WHISPER_LENS, "max_len": WHISPER_MAX_LEN}
                  if geom is WHISPER_SHAPE else {})
            r = time_block_table(kind, rec["name"], geom, fns, **at)
            rec["shapes"].append({
                "arch": geom[0], "H": geom[1], "KV": geom[2], "hd": geom[3],
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "eager_ms", "library_eager_ms")}})
    # after the timings, which it would otherwise precede with its own
    # allocations
    ranges = check_head_ranges(fns)
    for rec, kind in zip(records, ("decode", "prefill", "verify")):
        rec["head_range"] = ranges[kind]
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
    for r in sorted(profile_rows(prof),
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
    for rid, req in enumerate(reqs):
        max_new, toks = req[1], streams[rid]
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
               "spec_windows": sched.spec_windows,
               "decodes": int(sched._counts[3])}
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
    """falcon-mamba-7b at full width and ``SSM_SERVE_LAYERS`` layers
    through one-shot admission with the selective-scan kernel, graph
    segments against host-read ones; returns the kernel's launch count
    in the first graph run."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config

    base = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(base, n_layers=SSM_SERVE_LAYERS,
                              ssm=dataclasses.replace(base.ssm,
                                                      scan_impl="cuda"))
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
    kernels = [r for r in profile_rows(prof)
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
                               compute_dtype="float32",
                               n_layers=SSM_SERVE_LAYERS)
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


def submit_all(sched, reqs):
    """Submit every request at once: ``(prompt, max_new)``, or for the
    audio family ``(prompt, max_new, frames)``."""
    for rid, (prompt, max_new, *frames) in enumerate(reqs):
        sched.submit(prompt, max_new=max_new, request_id=rid,
                     **({"frames": frames[0]} if frames else {}))


def drive(sched, reqs):
    """Submit every request at once and drain; {rid: tokens}."""
    submit_all(sched, reqs)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}


def phase_serve():
    """llama3.2-1b at full width through the chunked paged scheduler
    with both kernels, graph segments against host-read ones; returns
    the kernels' launch counts in the first graph run."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg, params = llama_bf16()
    reqs = serving_requests(cfg)
    launches, runs = serve_in_turns(
        "serve", cfg, lambda loop: make_scheduler(params, cfg, loop), reqs)
    for run in runs:
        check_kernel_path(f"serve {run['loop']}", run["launches"])
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
    rows = profile_rows(prof)
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

    cfg, params = llama_bf16()
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

    cfg, params = llama_bf16()
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


PREFIX_POOL = 148   # 4 x blocks_for(512, 64) = 4 x 37 blocks: four cold
#                     residents of the 8 slots
SEG_STEPS = 8       # iterations a segment at most in phases 20-22: the
#                     resolution of their TTFT and ITL in steps
STREAM_POOL = 400   # phase 22: blocks for 8 cold residents (296) and
#                     more, so its preemptions are for slots, not blocks


def prefix_requests(cfg, kind, n=16, prompt_len=512):
    """``serving_requests``' shape (512-token prompts, ``max_new`` 32/64)
    for the prefix cache, numpy seed 2: ``"system"``, one 384-token
    system prompt (24 blocks of 16) and a distinct 128-token tail each;
    ``"pool4"``, whole prompts drawn from 4 distinct ones (request i
    takes prompt i % 4, as ``launch.serve --prompt-pool 4``)."""
    import numpy as np
    rng = np.random.default_rng(2)
    if kind == "system":
        system = rng.integers(2, cfg.vocab, 384)
        prompts = [np.concatenate([system, rng.integers(
            2, cfg.vocab, prompt_len - 384)]) for _ in range(n)]
    else:
        pool = [rng.integers(2, cfg.vocab, prompt_len) for _ in range(4)]
        prompts = [pool[i % 4] for i in range(n)]
    return [(p[None].astype(np.int32), 32 if i % 2 == 0 else 64)
            for i, p in enumerate(prompts)]


def latency_run(sched, reqs):
    """Submit every request at once and drive rounds of at most
    ``SEG_STEPS`` iterations; returns {rid: tokens}, the TTFT and ITL
    p50/p99 (``launch.serve.TokenClock``: seconds and iterations) and
    the wall seconds."""
    import torch
    from repro_torch.launch.serve import TokenClock
    clock, streams = TokenClock(), {}
    t0 = time.perf_counter()
    for rid, (prompt, max_new) in enumerate(reqs):
        sched.submit(prompt, max_new=max_new, request_id=rid)
        clock.arrive(rid, 0.0)
    while sched.pending:
        done = sched.step(max_steps=SEG_STEPS)
        clock.observe(sched, done, time.perf_counter() - t0)
        streams.update({f.request_id: f.tokens for f in done})
    torch.cuda.synchronize()
    return streams, clock.summary(), time.perf_counter() - t0


def check_kernel_path(tag, launches):
    if min(launches["paged_attention"], launches["flash_prefill"]) == 0 or \
            launches["gather"] != 0:
        raise AssertionError(f"{tag}: kernel path not taken: launches "
                             f"{launches}")


def check_drained(tag, sched):
    """After the drain only the prefix index's pins hold blocks, on the
    host mirror and on the device."""
    pinned = (sum(e.block_id >= 0 for e in
                  sched._prefix_index.entries.values())
              if sched.prefix_cache else 0)
    dev = int(sched.pool.cache["attn"].free_count)
    if not sched.free_blocks == sched.kv_blocks - pinned == dev:
        raise AssertionError(f"{tag}: free blocks {sched.free_blocks} "
                             f"(device {dev}) != {sched.kv_blocks} - "
                             f"{pinned} pinned")
    return pinned


def pair(summary, name, unit=""):
    """(p50, p99) of ``TokenClock.summary()``'s ``name``."""
    return summary[f"{name}_p50{unit}"], summary[f"{name}_p99{unit}"]


def fmt_pair(p, scale=1.0, digits=1):
    return "/".join("n/a" if v is None else f"{v * scale:.{digits}f}"
                    for v in p)


def cow_cost(sched, iters=64):
    """What ``ensure_private`` costs a call on the pool (a prefix-cache
    scheduler's sharing cache), all 8 rows, at the decode's shape (width
    1 at ``cur_len - 1``) and the chunk's (width 128 at ``pf_pos``), with
    nothing to copy (the serving path): as the segment captures it (the
    decision's kernels, then an IF node around the copy), device us a
    call from a counted ``DeviceLoop`` of ``iters`` calls less an empty
    one, and the kernels that run (the loop's captured nodes with the
    copy left out, less the empty loop's); and the branchless eager form
    (``graph_ms`` of one call; its kernels from ``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import device_loop
    node, p = sched.pool.cache["attn"], sched.pool
    carry = torch.zeros((), dtype=torch.int32, device=p.cur_len.device)

    def in_loop(body):
        with torch.no_grad():
            body(carry)
            loop = device_loop.DeviceLoop(None, body, carry, max_iters=iters,
                                          name="cow")
        nodes = sum(device_loop._nodes(g) for g in loop._graphs)
        loop.run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            loop.run()
        end.record()
        end.synchronize()
        loop.close()
        return start.elapsed_time(end) / (10 * iters), nodes

    empty = in_loop(lambda c: c)
    out = {}
    for name, start, width in (("decode", p.cur_len - 1, 1),
                               ("chunk", p.pf_pos, sched.chunk_tokens)):
        def body(c, start=start, width=width):
            node.ensure_private(start=start, width=width)
            return c
        ms = in_loop(body)[0] - empty[0]
        node._copy_on_write = lambda *a: None     # the decision alone
        try:
            nodes = in_loop(body)[1] - empty[1]
        finally:
            del node._copy_on_write
        with torch.no_grad():
            eager_ms = graph_ms(lambda _: body(carry), 1, reps=50)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                body(carry)
                torch.cuda.synchronize()
        n = sum(r.count for r in profile_rows(prof) if r.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchKernelExC"))
        out[name] = (ms, nodes, eager_ms, n)
    return out


def phase_prefix_cache():
    """llama3.2-1b at full width (bf16, the kernel path) through the
    chunked paged scheduler with the prefix cache, against the same
    requests with it off, on a pool of 148 blocks (four cold residents),
    in graph segments of at most 8 iterations: a shared 384-token system
    prompt with distinct tails, and whole prompts repeated from 4
    (``--prompt-pool 4``). Gates: every request finishes, both kernels
    launch (counted on the device), nothing gathers, one host read a
    segment, and after the drain the host's free blocks are the pool
    less the index's pins and equal the device's free count. Prints hit
    blocks, evictions, chunk iterations, TTFT and ITL p50/p99 (steps,
    wall), tok/s and peak residents; the copy-on-write's device cost a
    call. Then in fp32: warm streams equal cold ones and the cache-off
    run's, the kernel path's equal the gather path's with shared blocks
    mapped, and both kernels over a table with shared blocks mapped equal
    their plain versions; and speculation over shared blocks
    (``prefix_speculation``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import kernel as fp_kernel
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    cfg, params = llama_bf16()
    counters = launch_counters()
    for kind in ("system", "pool4"):
        reqs = prefix_requests(cfg, kind)
        runs = {}
        for pfx in (False, True):
            tag = f"prefix-cache {kind} {'on' if pfx else 'off'}"
            sched = make_scheduler(params, cfg, kv_blocks=PREFIX_POOL,
                                   prefix_cache=pfx)
            sched.warmup()
            for obj, attr in counters.values():
                setattr(obj, attr, 0)
            streams, s, wall = latency_run(sched, reqs)
            launches = {n: getattr(o, a) for n, (o, a) in counters.items()}
            check_streams(streams, reqs, cfg)
            check_kernel_path(tag, launches)
            if sched.host_reads != sched.segments:
                raise AssertionError(f"{tag}: {sched.host_reads} host reads "
                                     f"for {sched.segments} segments")
            pinned = check_drained(tag, sched)
            runs[pfx] = run = {
                "tok_s": sched.tokens_emitted / wall, "wall": wall,
                "iterations": sched.total_steps,
                "chunk_iters": int(sched._counts[2]),
                "hits": sched.prefix_hit_blocks,
                "evictions": sched.prefix_evictions,
                "peak": sched.peak_resident, "streams": streams, **s}
            log(f"[{tag}] {sched.loop_impl}, pool {PREFIX_POOL} blocks: "
                f"{sched.tokens_emitted} tokens in {wall:.3f} s -> "
                f"{run['tok_s']:.1f} tok/s; {run['iterations']} iterations "
                f"({run['chunk_iters']} ran a chunk); hit blocks "
                f"{run['hits']}, evictions {run['evictions']}, peak resident "
                f"{run['peak']}, pinned after the drain {pinned}; TTFT p50/"
                f"p99 {fmt_pair(pair(s, 'ttft_steps'), digits=0)} steps, "
                f"{fmt_pair(pair(s, 'ttft', '_s'), 1e3)} ms; ITL p50/p99 "
                f"{fmt_pair(pair(s, 'itl_steps'), digits=2)} steps, "
                f"{fmt_pair(pair(s, 'itl', '_s'), 1e3, 3)} ms; {sched.host_reads} "
                f"host reads for {sched.segments} segments; launches "
                f"{ {n: v for n, v in launches.items() if v} }")
            if pfx and kind == "system":
                for name, (ms, nodes, eager, n) in cow_cost(sched).items():
                    log(f"[prefix-cache] copy-on-write, {name} call (8 rows, "
                        f"nothing to copy; one a {name} iteration): in the "
                        f"segment {ms * 1e3:.1f} us device, {nodes} kernels "
                        f"run (the decision; the copy behind an IF node); "
                        f"branchless eager form {eager * 1e3:.1f} us, {n} "
                        f"kernels")
            sched.close()
        off, on = runs[False], runs[True]
        log(f"[prefix-cache {kind}] on vs off: chunk iterations "
            f"{on['chunk_iters']} vs {off['chunk_iters']}, iterations "
            f"{on['iterations']} vs {off['iterations']}, tok/s "
            f"{on['tok_s']:.1f} vs {off['tok_s']:.1f}, TTFT p99 "
            f"{on['ttft_steps_p99']:.0f} vs {off['ttft_steps_p99']:.0f} "
            f"steps, peak "
            f"resident {on['peak']} vs {off['peak']}")
    del params
    free_device_memory("the fp32 prefix-cache runs")

    fcfg = dataclasses.replace(get_config("llama3.2-1b"),
                               compute_dtype="float32", attn_impl="cuda")
    fparams = bridge.init_params(fcfg, seed=0, device="cuda")
    reqs = prefix_requests(fcfg, "pool4")[:8]
    runs = parity_runs(
        "prefix-parity", lambda c, loop, **kw: make_scheduler(
            fparams, c, loop, kv_blocks=PREFIX_POOL, **kw), reqs,
        [("cuda-on", fcfg, None, dict(prefix_cache=True)),
         ("cuda-off", fcfg, None),
         ("gather-on", dataclasses.replace(fcfg, attn_impl="gather"), None,
          dict(prefix_cache=True))])
    same_streams("prefix-parity", runs, "cuda-on", "cuda-off",
                 "prefix cache on and off")
    same_streams("prefix-parity", runs, "cuda-on", "gather-on",
                 "kernel path and gather path with shared blocks")
    warm = sum(bool((runs["cuda-on"][r + 4] == runs["cuda-on"][r]).all())
               for r in range(4))
    log(f"[prefix-parity] warm streams (requests 4-7) equal the cold ones "
        f"of their prompts (0-3): {warm}/4")
    if warm != 4:
        raise AssertionError("warm streams differ from cold ones in fp32")
    # both kernels on a table with shared blocks mapped: two warm
    # admissions, held before their first chunk (a segment of 0 steps)
    sched = make_scheduler(fparams, fcfg, kv_blocks=PREFIX_POOL,
                           prefix_cache=True)
    drive(sched, reqs[:1])
    for rid in (100, 101):
        sched.submit(reqs[0][0], max_new=2, request_id=rid)
    sched.step(max_steps=0)
    node, p = sched.pool.cache["attn"], sched.pool
    rows = torch.nonzero(p.prefilling).flatten()
    table = node.table[rows].contiguous()
    hits = int(p.pf_pos[rows[0]]) // sched.kv_block
    if not (len(rows) == 2 and hits == 31 and
            bool((table[0, :hits] == table[1, :hits]).all()) and
            bool((node.refcount[table[0, :hits].long()] == 3).all())):
        raise AssertionError(f"prefix-parity: warm rows do not share the "
                             f"31 hit blocks: pf_pos {p.pf_pos[rows]}")
    dev = node.k_pool.device
    g = torch.Generator(device=dev).manual_seed(0)
    H, hd = fcfg.n_heads, fcfg.resolved_head_dim
    q_off = p.pf_pos[rows].contiguous()
    errs = {}
    for name, kern, ref, q in (
            ("paged_attention", pa_kernel.paged_attention,
             paged_attention_ref,
             torch.randn((2, 1, H, hd), generator=g, device=dev)),
            ("flash_prefill", fp_kernel.flash_prefill, flash_prefill_ref,
             torch.randn((2, sched.chunk_tokens, H, hd), generator=g,
                         device=dev))):
        args = (q, node.k_pool[0], node.v_pool[0], table, q_off)
        errs[name] = float((kern(*args) - ref(*args)).abs().max())
    log(f"[prefix-parity] fp32 kernels over the warm rows' table (31 "
        f"shared blocks, refcount 3: two rows and the pin), max |kernel - "
        f"plain|: {errs}")
    if max(errs.values()) > TOL["float32"]:
        raise AssertionError(f"kernels disagree over shared blocks: {errs}")
    sched.run_until_drained()
    check_drained("prefix-parity", sched)
    sched.close()
    del fparams
    prefix_speculation()


def prefix_speculation():
    """Speculation over shared blocks, at smoke width (the smoke
    llama3.2-1b at head dim 64, fp32, the kernel path): 12 requests of 64
    tokens from 3 prompts (so that a hit lands in a slot that held
    another prompt) that each tile one random 4-token segment, 4 slots,
    block 16, chunk 16, through the n-gram drafter and the model
    drafter (the target drafting for itself, which accepts nearly every
    window without hits) with the prefix cache on and off. The draft
    model's own cache shares no block, so admission prefills its hit
    positions (the JAX package leaves them stale). Gates: every greedy
    stream equals the non-speculative run's, ``flash_verify`` launches
    (counted on the device), and the model drafter's accept rate with
    hits is within ``DRAFT_RATE_TOL`` of its rate without. Prints accept
    rates and hits."""
    import dataclasses
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs import get_config
    small = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                                compute_dtype="float32", attn_impl="cuda",
                                head_dim=64, n_heads=8, n_kv_heads=2,
                                d_model=128)
    tp = bridge.init_params(small, seed=0, device="cuda")
    rng = np.random.default_rng(5)
    pool = [np.resize(rng.integers(2, small.vocab, 4), 64) for _ in range(3)]
    reqs = [(pool[i % 3][None].astype(np.int32), 16) for i in range(12)]
    counters = launch_counters()

    def run(**kw):
        sched = make_scheduler(tp, small, **{
            **dict(n_slots=4, prompt_len=64, max_new_cap=16,
                   chunk_tokens=16), **kw})
        sched.warmup()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        streams = drive(sched, reqs)
        out = (streams, sched.accept_rate, sched.prefix_hit_blocks,
               getattr(*counters["flash_verify"]))
        sched.close()
        return out

    plain = run()[0]
    for drafter, extra in (("ngram", {}),
                           ("model", dict(draft_params=tp, draft_cfg=small))):
        got = {pfx: run(speculative=spec_config(drafter=drafter),
                        prefix_cache=pfx, **extra) for pfx in (False, True)}
        same = {pfx: sum(bool((g[0][r] == plain[r]).all()) for r in plain)
                for pfx, g in got.items()}
        log(f"[prefix-spec] {drafter} drafter (k={SPEC_K}), fp32 smoke: "
            f"accept rate {got[False][1]:.4f} without the prefix cache, "
            f"{got[True][1]:.4f} with it ({got[True][2]} hit blocks); "
            f"flash_verify launches {got[False][3]}, {got[True][3]}; "
            f"streams equal the non-speculative run's {same[False]}/"
            f"{len(plain)}, {same[True]}/{len(plain)}")
        if min(same.values()) != len(plain) or min(
                g[3] for g in got.values()) == 0 or got[True][2] == 0:
            raise AssertionError(f"prefix-spec {drafter}: streams differ, "
                                 f"no verify launch or no hit")
        if drafter == "model" and \
                abs(got[True][1] - got[False][1]) > DRAFT_RATE_TOL:
            raise AssertionError("prefix-spec: the model drafter accepts "
                                 "less after prefix hits")


def slo_arrivals(reqs):
    """{round: [rid]}: the 12 batch requests (i % 4 != 3) at round 0,
    the interactive ones (i % 4 == 3) at rounds 2, 4, 6 and 8, when
    batch traffic holds the pool."""
    out = {0: [i for i in range(len(reqs)) if i % 4 != 3]}
    for k, i in enumerate(i for i in range(len(reqs)) if i % 4 == 3):
        out[2 * (k + 1)] = [i]
    return out


def slo_run(sched, reqs):
    """The scripted overload through ``SLOScheduler`` (segments of at
    most 8 iterations): the events, the summary and the wall seconds."""
    import torch
    from repro_torch.serve import slo as slo_lib
    slo = slo_lib.SLOScheduler(sched, segment_steps=SEG_STEPS)
    arrivals = slo_arrivals(reqs)
    events, r = [], 0
    t0 = time.perf_counter()
    while r <= max(arrivals) or slo.pending:
        for rid in arrivals.get(r, []):
            prompt, max_new = reqs[rid]
            slo.submit(prompt, max_new=max_new, request_id=rid,
                       slo_class="interactive" if rid % 4 == 3
                       else "batch")
        events += slo.step()
        r += 1
    torch.cuda.synchronize()
    return events, slo.json_summary(), time.perf_counter() - t0


def delivered(events, n):
    import numpy as np
    out = {r: [] for r in range(n)}
    for e in events:
        if e.kind in ("token", "finished"):
            out[e.request_id] += e.tokens
    return {r: np.asarray(t, np.int32) for r, t in out.items()}


def fmt_classes(s):
    parts = []
    for name, c in s["classes"].items():
        parts.append(
            f"{name}: {c['completed']} done, {c['preempted_times']} "
            f"preempted, TTFT p50/p99 "
            f"{fmt_pair((c['ttft_steps']['p50'], c['ttft_steps']['p99']), digits=0)}"
            f" steps, {fmt_pair((c['ttft_wall_s']['p50'], c['ttft_wall_s']['p99']), 1e3)}"
            f" ms; ITL p50/p99 "
            f"{fmt_pair((c['itl_steps']['p50'], c['itl_steps']['p99']), digits=2)}"
            f" steps, {fmt_pair((c['itl_wall_s']['p50'], c['itl_wall_s']['p99']), 1e3, 3)}"
            f" ms")
    return "; ".join(parts)


def phase_slo():
    """llama3.2-1b at full width (bf16, the kernel path) through
    ``SLOScheduler`` on the chunked paged pool: the 16 serving requests,
    12 batch at once and 4 interactive arriving two rounds apart while
    batch traffic holds all 148 blocks, and the same requests
    uncontended (16 slots and their blocks). Gates: preemptions (none
    uncontended), every
    request finishes, both kernels launch (counted on the device) and
    nothing gathers, interactive TTFT p99 in steps below batch's. Prints
    per class p50/p99 TTFT and ITL (steps, wall), preemptions and host
    reads a round. Then in fp32 the overload's delivered streams,
    preempted requests' included, must equal the uninterrupted ones (the
    FIFO scheduler, 8 slots, no block shortage)."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config

    counters = launch_counters()
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  compute_dtype=dtype, attn_impl="cuda")
        params = bridge.init_params(cfg, seed=0, device="cuda")
        reqs = serving_requests(cfg)
        out = {}
        if dtype == "float32":
            # the uninterrupted streams: FIFO, 8 slots, no block shortage
            ref = drive(make_scheduler(params, cfg), reqs)
        # bf16: uncontended = a slot and blocks for every request at once
        for name, kw in (("overload", dict(kv_blocks=PREFIX_POOL)),
                         ("uncontended", dict(n_slots=16)))[
                             :2 if dtype == "bfloat16" else 1]:
            tag = f"slo {name} {dtype}"
            sched = make_scheduler(params, cfg, **kw)
            sched.warmup()
            for obj, attr in counters.values():
                setattr(obj, attr, 0)
            events, s, wall = slo_run(sched, reqs)
            launches = {n: getattr(o, a) for n, (o, a) in counters.items()}
            streams = delivered(events, len(reqs))
            check_streams(streams, reqs, cfg)
            check_kernel_path(tag, launches)
            n_pre = sum(e.kind == "preempted" for e in events)
            out[name] = (streams, s, n_pre)
            log(f"[{tag}] {sched.loop_impl}, {sched.n_slots} slots, pool "
                f"{sched.kv_blocks} blocks, segments <= {SEG_STEPS}: "
                f"{sched.tokens_emitted} tokens in {wall:.3f} s, "
                f"{s['total_steps']} steps, {s['preemptions']} preemptions "
                f"({n_pre} events), {s['replay_mismatches']} replay "
                f"mismatches; {s['rounds']} rounds, {s['host_reads']} host "
                f"reads ({s['host_reads'] / max(s['rounds'], 1):.3f} a "
                f"round; segments {sched.segments}); {fmt_classes(s)}")
            if s["replay_mismatches"]:
                raise AssertionError(f"{tag}: a replay differs from what "
                                     f"was delivered")
            if s["host_reads"] > s["rounds"]:
                raise AssertionError(f"{tag}: more than one host read a "
                                     f"round")
            sched.close()
        streams, s, n_pre = out["overload"]
        if s["preemptions"] == 0:
            raise AssertionError(f"slo {dtype}: no preemption under "
                                 f"overload")
        c = s["classes"]
        if dtype == "bfloat16" and not (c["interactive"]["ttft_steps"]["p99"]
                                        < c["batch"]["ttft_steps"]["p99"]):
            raise AssertionError("slo: interactive TTFT p99 (steps) not "
                                 "below batch's")
        if dtype == "bfloat16" and out["uncontended"][1]["preemptions"]:
            raise AssertionError("slo: the uncontended run preempted")
        if dtype == "float32":
            victims = sorted({e.request_id for e in events
                              if e.kind == "preempted"})
            same = sum(len(streams[r]) == len(ref[r]) and
                       bool((streams[r] == ref[r]).all()) for r in ref)
            log(f"[slo float32] delivered streams equal the uninterrupted "
                f"FIFO run's (8 slots, 296 blocks) for {same}/{len(ref)} "
                f"requests (preempted: {victims})")
            if same != len(ref):
                raise AssertionError("slo: a preempted request's stream "
                                     "differs from its uninterrupted one")
        del params


def phase_stream():
    """``launch.serve --stream --prefix-cache --hi-every 4`` at llama3.2-1b
    full width (bf16, the kernel path) through ``StreamingFrontend`` (the
    scheduler stepped on its worker thread, the segment captured on the
    main thread): 16 requests of 512 tokens from a pool of 4 prompts,
    arriving eight at a time 0.1 s apart (a ``--trace`` file), so that
    the second eight find every slot held; a pool of 400 blocks
    (``STREAM_POOL``). Gates: every stream ends in ``done`` with its
    ``max_new`` tokens, some stream is preempted, no replay differs, both
    kernels launch and nothing gathers. Prints the per-class summary."""
    import os
    import tempfile
    from repro_torch.launch import serve as launch_serve
    counters = launch_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    # the launcher orders the trace by (arrival, max_new)
    rows = sorted((0.1 * (i // 8), 32 if i % 2 == 0 else 64)
                  for i in range(16))
    fd, trace = tempfile.mkstemp(suffix=".csv", text=True)
    with os.fdopen(fd, "w") as f:
        f.write("# arrival_s,max_new\n")
        f.writelines(f"{t},{m}\n" for t, m in rows)
    try:
        s = launch_serve.main([
            "--arch", "llama3.2-1b", "--attn-impl", "cuda", "--kv", "paged",
            "--kv-blocks", str(STREAM_POOL), "--prefill", "chunked",
            "--chunk-tokens", "128", "--slots", "8", "--prompt-len", "512",
            "--trace", trace, "--prompt-pool", "4", "--eos-id", "-1",
            "--stream", "--prefix-cache", "--hi-every", "4",
            "--segment-steps", str(SEG_STEPS)])
    finally:
        os.unlink(trace)
    launches = {n: getattr(o, a) for n, (o, a) in counters.items()}
    check_kernel_path("stream", launches)
    bad = [i for i, r in s["streams"].items()
           if r["last"] != "done" or len(r["tokens"]) != rows[i][1]]
    n_pre = sum(r["preempted"] for r in s["streams"].values())
    log(f"[stream] {len(s['streams'])} streams, {n_pre} preempted events, "
        f"launches { {n: v for n, v in launches.items() if v} }; "
        f"{fmt_classes(s)}; {s['rounds']} rounds, {s['host_reads']} host "
        f"reads, {s['segments']} segments")
    if bad or len(s["streams"]) != 16 or s["replay_mismatches"]:
        raise AssertionError(f"stream: streams {bad} did not end in done "
                             f"with their max_new tokens")
    if n_pre == 0:
        raise AssertionError("stream: no preempted event under a tight "
                             "pool")
    return s


# ------------------------------------------------------- adaptive depth

EXIT_AT = 2          # phase 23: blocks from this layer on are identities
EXIT_SWEEP = (0.05, 0.2, 0.8)   # finite thresholds on the undoctored model
UNEMBED_B = 8        # rows of the exit margin timed alone (8 slots)


def identity_tail(params, e):
    """``wo`` and ``w_down`` zeroed from layer ``e`` on (fresh tensors
    for those two leaves, the rest shared): both residual branches add
    exact zeros, so those layers are identities
    (``benchmarks/bench_adaptive_depth.py``'s construction)."""
    out = dict(params)
    lay = out["layers"] = dict(params["layers"])
    mlp = "moe" if "moe" in lay else "mlp"
    lay["attn"], lay[mlp] = dict(lay["attn"]), dict(lay[mlp])
    # an MoE block's output is its experts' and its shared experts' sum
    zero = [(lay["attn"], "wo"), (lay[mlp], "w_down")] + (
        [(lay[mlp], "shared_down")] if "shared_down" in lay[mlp] else [])
    for tree, name in zero:
        tree[name] = tree[name].clone()
        tree[name][e:] = 0
    return out


@contextlib.contextmanager
def idle_layer_loops(counter):
    """Inside the context each early-exit decode step adds one to the 0-d
    int64 CUDA tensor ``counter`` when its layer loop has no live row
    (every emitting row retires in that iteration, so the loop runs no
    layer): an add on the device, so that a graph captured inside the
    context counts at each replay and an eager run inside it at each
    call, with no host read."""
    from repro_torch.serve import engine
    plain = engine.decode_step

    def counted(*args, **kw):
        live = kw.get("live")
        if live is not None:
            counter.add_((~live.any()).to(counter.dtype))
        return plain(*args, **kw)

    engine.decode_step = counted
    try:
        yield
    finally:
        engine.decode_step = plain


def counted_run(tag, sched, reqs, counter, driver=None):
    """``adaptive_run`` with ``counter`` (``idle_layer_loops``) zeroed
    before it; adds ``idle``, the decode steps whose layer loop ran no
    layer, which launch no kernel of a layer."""
    counter.zero_()
    run = adaptive_run(tag, sched, reqs, driver)
    run["idle"] = int(counter)
    return run


def ready(sched, reqs, driver=None):
    """Capture (a graph scheduler) and warm up on one request."""
    import torch
    sched.warmup()
    (driver or drive)(sched, reqs[:1])
    torch.cuda.synchronize()
    return sched


def adaptive_run(tag, sched, reqs, driver=None):
    """One run of ``reqs``: streams, kernel launches (counted on the
    device in a graph segment, in Python at each eager launch), mean
    depth, tok/s, and for a graph run the device's time in segments
    (CUDA events) with its gates: one host read a segment and no
    predicate read. ``driver`` submits and drains (``drive``, or
    ``vlm_drive`` for requests with patches)."""
    import torch
    from repro_torch import core
    from repro_torch.core.device_loop import DeviceLoop
    counters = launch_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    graph = sched.loop_impl.startswith("cuda-graph:")
    reads0 = (DeviceLoop.host_reads, core.while_loop.host_reads)
    finish = instrument_sync(sched) if graph else None
    t0 = time.perf_counter()
    streams = (driver or drive)(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_streams(streams, [r[:2] for r in reqs], sched.cfg)
    reads = (DeviceLoop.host_reads - reads0[0],
             core.while_loop.host_reads - reads0[1])
    run = {"streams": streams, "wall": wall,
           "tok_s": sched.tokens_emitted / wall,
           "launches": {n: getattr(o, a) for n, (o, a) in counters.items()},
           "mean_depth": sched.mean_depth, "depth_impl": sched.depth_impl,
           "iterations": sched.total_steps,
           "decodes": int(sched._counts[3]), "reads": reads}
    line = (f"[{tag}] {sched.loop_impl}, layer loop {sched.depth_impl}: "
            f"{sched.tokens_emitted} tokens in {wall:.3f} s -> "
            f"{run['tok_s']:.1f} tok/s, {run['iterations']} iterations "
            f"({run['decodes']} with a decode), mean depth "
            f"{run['mean_depth']:.4f}, launches pa "
            f"{run['launches']['paged_attention']} fp "
            f"{run['launches']['flash_prefill']}, {sched.segments} segments,"
            f" {sched.host_reads} harvest reads, {reads[1]} predicate reads")
    if graph:
        if not sched.host_reads == sched.segments == sched.graph_replays > 0:
            raise AssertionError(
                f"{tag}: {sched.host_reads} host reads, "
                f"{sched.graph_replays} graph launches for {sched.segments}"
                f" segments")
        if reads != (sched.segments, 0):
            raise AssertionError(f"{tag}: (transfers, predicate reads) "
                                 f"{reads} in {sched.segments} graph "
                                 f"segments")
        _, _, _, seg_ms = finish()
        run["seg_ms"] = seg_ms
        run["ms_iter"] = seg_ms / max(run["iterations"], 1)
        line += (f"; device in segments {seg_ms:.1f} ms = "
                 f"{run['ms_iter']:.4f} ms an iteration")
    log(line)
    if run["launches"]["gather"]:
        raise AssertionError(f"{tag}: the gather path ran")
    return run


def same_count(tag, got, want):
    """Greedy streams equal, request for request (a gate)."""
    same = sum(len(got[r]) == len(want[r]) and bool((got[r] == want[r]).all())
               for r in want)
    log(f"[{tag}] streams equal {same}/{len(want)}")
    if same != len(want):
        raise AssertionError(f"{tag}: streams equal {same}/{len(want)}")


def margin_cost(params, cfg):
    """``exit_margin``'s device ms a call at B = UNEMBED_B (CUDA-graph
    replays of four calls on four hidden-state copies) beside its byte
    bound: the unembed read once, the rows and the margin moved once."""
    import torch
    from repro_torch.models import adaptive
    gen = torch.Generator(device="cuda").manual_seed(23)
    xs = [torch.randn((UNEMBED_B, 1, cfg.d_model), generator=gen,
                      device="cuda").to(cfg.dtype("compute"))
          for _ in range(4)]
    ms = graph_ms(lambda i: adaptive.exit_margin(params, cfg, xs[i]), 4)
    w = params["embed"]
    nbytes = (w.numel() * w.element_size()
              + xs[0].numel() * xs[0].element_size()
              + params["ln_final"].numel() * 4 + UNEMBED_B * 4)
    flops = 2 * UNEMBED_B * cfg.d_model * cfg.padded_vocab
    bound = max(nbytes / HBM_BYTES_PER_S,
                flops / PEAK_FLOPS["bfloat16"]) * 1e3
    return ms, bound, nbytes


def phase_adaptive(plain_launches):
    """Adaptive depth at llama3.2-1b full width (bf16, the chunked paged
    pool of phase 4, the 16 serving requests): (a) threshold inf, graph
    and host-read, against the non-adaptive graph run; (b) exit by
    construction at an identity tail from layer ``EXIT_AT``; (c)
    mixture-of-depths in fp32 through graph, host-read and
    batch-synchronous decoding; (d) times (printed, not gated)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serve import engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="cuda")
    L = cfg.n_layers
    params = bridge.init_params(cfg, seed=0, device="cuda")
    reqs = serving_requests(cfg)
    inf = dataclasses.replace(cfg, early_exit=True)

    # (a) threshold inf against the non-adaptive graph run, in turns; a
    # decode step whose emitting rows all retire keeps no layer loop
    # alive, so the adaptive runs launch L fewer paged_attention calls
    # for each (``idle``, counted on the device)
    idle = {k: torch.zeros((), dtype=torch.int64, device="cuda")
            for k in ("graph", "host")}
    plain = ready(make_scheduler(params, cfg), reqs)
    with idle_layer_loops(idle["graph"]):
        ada = ready(make_scheduler(params, inf), reqs)
    host = ready(make_scheduler(params, inf, "host"), reqs)
    a1 = adaptive_run("adaptive inf plain", plain, reqs)
    b1 = counted_run("adaptive inf graph", ada, reqs, idle["graph"])
    with idle_layer_loops(idle["host"]):
        h = counted_run("adaptive inf host-read", host, reqs, idle["host"])
    b2 = counted_run("adaptive inf graph", ada, reqs, idle["graph"])
    a2 = adaptive_run("adaptive inf plain", plain, reqs)
    host.close()
    want = {k: a1["launches"][k] for k in ("paged_attention",
                                           "flash_prefill")}
    if want != plain_launches:
        raise AssertionError(f"adaptive: the non-adaptive run launched "
                             f"{want}, phase 4 {plain_launches}")
    for run in (b1, h, b2):
        same_count(f"adaptive inf {run['depth_impl']}", run["streams"],
                   a1["streams"])
        got = {k: run["launches"][k] for k in want}
        less = {"paged_attention": want["paged_attention"]
                - L * run["idle"], "flash_prefill": want["flash_prefill"]}
        if run["mean_depth"] != float(L) or got != less or \
                run["idle"] != h["idle"]:
            raise AssertionError(
                f"adaptive inf ({run['depth_impl']}): mean depth "
                f"{run['mean_depth']}, launches {got} against {less} "
                f"({run['idle']} decode steps with every emitting row "
                f"retiring; host-read {h['idle']})")
    log(f"[adaptive] inf: {h['idle']} decode step(s) with every emitting "
        f"row retiring ran no layer, {L * h['idle']} paged_attention "
        f"launches fewer than the non-adaptive run's")
    if b1["depth_impl"] != "cuda-graph:if-per-layer" or \
            h["depth_impl"] != "host-read":
        raise AssertionError(f"adaptive: lowerings {b1['depth_impl']}, "
                             f"{h['depth_impl']}")
    log(f"[adaptive] inf: host-read lowering read the halt vector "
        f"{h['reads'][1]} times ({h['reads'][1] / max(h['decodes'], 1):.2f}"
        f" a decode iteration, {L} layers); graph lowering 0")

    # (b) exit by construction: identities from layer EXIT_AT, every row
    # halting after it (threshold -1, floor EXIT_AT)
    doc = identity_tail(params, EXIT_AT)
    ecfg = dataclasses.replace(cfg, early_exit=True, exit_threshold=-1.0,
                               exit_min_layers=EXIT_AT)
    dplain = ready(make_scheduler(doc, cfg), reqs)
    with idle_layer_loops(idle["graph"]):
        dexit = ready(make_scheduler(doc, ecfg), reqs)
    dhost = ready(make_scheduler(doc, ecfg, "host"), reqs)
    c1 = adaptive_run("adaptive exit plain", dplain, reqs)
    d1 = counted_run("adaptive exit graph", dexit, reqs, idle["graph"])
    with idle_layer_loops(idle["host"]):
        dh = counted_run("adaptive exit host-read", dhost, reqs,
                         idle["host"])
    d2 = counted_run("adaptive exit graph", dexit, reqs, idle["graph"])
    c2 = adaptive_run("adaptive exit plain", dplain, reqs)
    for sched in (dplain, dexit, dhost):
        sched.close()
    for run in (d1, dh, d2):
        same_count(f"adaptive exit {run['depth_impl']}", run["streams"],
                   c1["streams"])
        pa, fp = (run["launches"][k] for k in ("paged_attention",
                                                "flash_prefill"))
        # EXIT_AT layers a decode step that has a live row
        if run["mean_depth"] != float(EXIT_AT) or \
                pa * L != (c1["launches"]["paged_attention"]
                           - L * run["idle"]) * EXIT_AT or \
                run["idle"] != dh["idle"] or \
                fp != c1["launches"]["flash_prefill"]:
            raise AssertionError(
                f"adaptive exit ({run['depth_impl']}): mean depth "
                f"{run['mean_depth']}, launches pa {pa} fp {fp} against "
                f"{c1['launches']} ({run['idle']} decode steps with every "
                f"emitting row retiring; host-read {dh['idle']})")
    log(f"[adaptive] exit at {EXIT_AT}: paged_attention "
        f"{d1['launches']['paged_attention']} = {EXIT_AT}/{L} of "
        f"{c1['launches']['paged_attention']} less {L} x {d1['idle']} "
        f"(device-counted; the decode steps with every emitting row "
        f"retiring run no layer), flash_prefill "
        f"{d1['launches']['flash_prefill']} unchanged")

    # (d) the margin alone, and the sweep on the undoctored model
    m_ms, m_bound, m_bytes = margin_cost(params, cfg)
    sweep = []
    for thr in EXIT_SWEEP:
        sched = ready(make_scheduler(params, dataclasses.replace(
            inf, exit_threshold=thr)), reqs)
        run = adaptive_run(f"adaptive threshold {thr:g}", sched, reqs)
        sched.close()
        if not 1.0 <= run["mean_depth"] <= L:
            raise AssertionError(f"adaptive threshold {thr}: mean depth "
                                 f"{run['mean_depth']}")
        sweep.append((thr, run["mean_depth"], run["tok_s"]))
    plain.close()
    ada.close()
    dec = max(a1["decodes"], 1)
    extra = [(b["seg_ms"] - a["seg_ms"]) / dec for a, b in ((a1, b1),
                                                             (a2, b2))]
    log(f"[adaptive] {smi}: tok/s non-adaptive {a1['tok_s']:.1f}, "
        f"{a2['tok_s']:.1f}; inf {b1['tok_s']:.1f}, {b2['tok_s']:.1f} "
        f"(host-read {h['tok_s']:.1f}); doctored non-adaptive "
        f"{c1['tok_s']:.1f}, {c2['tok_s']:.1f}; exit at {EXIT_AT} "
        f"{d1['tok_s']:.1f}, {d2['tok_s']:.1f} (host-read {dh['tok_s']:.1f})"
        f" | device ms an iteration: non-adaptive {a1['ms_iter']:.4f}, "
        f"{a2['ms_iter']:.4f}; inf {b1['ms_iter']:.4f}, "
        f"{b2['ms_iter']:.4f}; doctored {c1['ms_iter']:.4f}, "
        f"{c2['ms_iter']:.4f}; exit {d1['ms_iter']:.4f}, "
        f"{d2['ms_iter']:.4f}")
    log(f"[adaptive] {smi}: exit_margin at B={UNEMBED_B} {m_ms:.4f} ms a "
        f"call (device, CUDA-graph replay), bound {m_bound:.4f} ms "
        f"({m_bytes / 1e6:.1f} MB, bytes); inf's extra device ms a decode "
        f"iteration {extra[0]:.4f}, {extra[1]:.4f}, of which {L} margins "
        f"{L * m_ms:.4f}, the rest (the {2 * L} IF nodes, the state "
        f"updates) {extra[0] - L * m_ms:.4f}, {extra[1] - L * m_ms:.4f}")
    log(f"[adaptive] {smi}: mean depth at thresholds "
        + ", ".join(f"{t:g}: {d:.4f} ({r:.1f} tok/s)" for t, d, r in sweep)
        + f"; inf {float(L):.1f}")
    del params, doc, plain, ada, host, dplain, dexit, dhost
    free_device_memory("the mixture-of-depths run")

    # (c) mixture-of-depths, fp32: graph, host-read and batch-sync
    mcfg = dataclasses.replace(cfg, compute_dtype="float32",
                               mod_capacity=0.5, mod_every=2)
    mparams = bridge.init_params(mcfg, seed=0, device="cuda")
    sub = reqs[:8]
    runs = {}
    for loop in ("graph", "host"):
        sched = ready(make_scheduler(mparams, mcfg, loop), sub)
        runs[loop] = adaptive_run(f"adaptive mod {loop}", sched, sub)
        sched.close()
    same_count("adaptive mod host-read", runs["host"]["streams"],
               runs["graph"]["streams"])
    cap = max(m for _, m in sub)
    prompts = torch.from_numpy(np.concatenate([p for p, _ in sub])).cuda()
    t0 = time.perf_counter()
    with torch.no_grad():
        res = engine.generate_batch_sync(mparams, mcfg, prompts,
                                         max_new=cap, eos_id=-1,
                                         kv_impl="paged", kv_block=16)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    toks = res.tokens.cpu().numpy()
    same_count("adaptive mod batch-sync", {
        r: toks[r, :len(runs["graph"]["streams"][r])] for r in range(8)},
        runs["graph"]["streams"])
    log(f"[adaptive] mod (capacity 0.5, every 2, zero routers) fp32: mean "
        f"depth {runs['graph']['mean_depth']:.4f} graph, "
        f"{runs['host']['mean_depth']:.4f} host-read; batch-sync "
        f"{sync_s:.3f} s for 8 x {cap}")


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


def rnn_graph_passes(params, x, lens, H, cell, label, ref, host_ms):
    """Three same-shape ``dynamic_rnn(impl="graph")`` inference passes
    (the first captures): one capture, one graph launch a pass, no
    predicate read, the loop's steps = max(lens) (the fused cell's
    launches inside the WHILE node), outputs within RNN_TOL of the host
    lowering's ``ref``. Returns the graph's ms per step (passes 2-3)."""
    import torch
    from repro_torch import core
    from repro_torch.core.device_grad import GradLoop
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.models import rnn

    max_len = int(lens.max())
    cap0, rep0, hr0 = GradLoop.captures, GradLoop.replays, GradLoop.host_reads
    reads0 = core.while_loop.host_reads
    py0 = lstm_kernel.lstm_cell.launches
    secs = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rnn.dynamic_rnn(params, x, lens, hidden=H, cell=cell,
                                  impl="graph")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    loop = core.while_loop.last_grad_loop
    steps = loop.iterations()
    captures = GradLoop.captures - cap0
    launches = GradLoop.replays - rep0
    reads = core.while_loop.host_reads - reads0
    checks = GradLoop.host_reads - hr0
    py = lstm_kernel.lstm_cell.launches - py0
    err = max((a - r).abs().max().item() for a, r in zip(
        (out[0], *out[1]), (ref[0], *ref[1])))
    ok = all(torch.allclose(a, r, rtol=RNN_TOL, atol=RNN_TOL) for a, r in
             zip((out[0], *out[1]), (ref[0], *ref[1])))
    ms = (secs[1] + secs[2]) / 2 / max_len * 1e3
    log(f"[rnn] graph lowering, {label}: {captures} capture over 3 passes "
        f"(first pass {secs[0]:.3f} s with the capture), {launches} graph "
        f"launches ({launches / 3:.0f} a pass), predicate host reads "
        f"{reads}, double-write checks after the loop {checks}; WHILE-node "
        f"steps {steps} (max(lens) {max_len}"
        + (f"; lstm_cell launches inside it {steps}, Python counter "
           f"+{py} at warm-up and capture" if py else "")
        + f"); max |graph - host| {err:.3e} (tol {RNN_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms/step graph vs "
        f"{host_ms:.4f} host (in turns host, graph, graph, host)")
    if not ok:
        raise AssertionError(f"dynamic_rnn(impl='graph') {label} disagrees "
                             f"with the host lowering")
    if captures != 1 or launches != 3 or reads != 0 or steps != max_len:
        raise AssertionError(
            f"dynamic_rnn(impl='graph') {label}: captures {captures} (want "
            f"1), launches {launches} (want 3), predicate reads {reads} "
            f"(want 0), steps {steps} (want {max_len})")
    if out[0][lens.argmin(), max_len - 1].abs().max().item() != 0:
        raise AssertionError("graph output past a sequence's length is "
                             "not zero")
    return ms


def phase_dynamic_rnn():
    """dynamic_rnn inference through the fused cell against the unfused
    cell at B=512, D=H=512, S=1000 (ragged lengths), under the host
    lowering and the graph lowering; returns the kernel's launches in the
    fused host pass. Then dynamic vs static (Fig. 14)."""
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
    # the graph lowering, each cell in turns with its host pass
    from repro_torch.core import device_grad
    graph_ms = {}
    for label, cell, ref, wall_h in (
            ("fused cell", fused, (out_k, (c_k, h_k)), wall),
            ("unfused cell", rnn.lstm_cell, (out, (c, h)), wall_plain)):
        g_ms = rnn_graph_passes(params, x, lens, H, cell, label, ref,
                                wall_h / max_len * 1e3)
        with torch.no_grad():
            t0 = time.perf_counter()
            rnn.dynamic_rnn(params, x, lens, hidden=H, cell=cell)
            torch.cuda.synchronize()
            again = time.perf_counter() - t0
        host_ms = (wall_h + again) / 2 / max_len * 1e3
        graph_ms[label] = (g_ms, host_ms)
        device_grad.release()
    log("[rnn] graph vs host ms/step (host: mean of the passes before and "
        "after the graph's): " + ", ".join(
            f"{k} {g:.4f} vs {h:.4f} ({h / g:.2f}x)"
            for k, (g, h) in graph_ms.items()))
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
    rows = [r for r in profile_rows(prof)
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
    four save policies at B=512, D=H=512, S = 100 and 500, under the
    host lowering and then the graph lowering; then Fig. 2's ``scan``
    in the graph (``fig2_graph``)."""
    import torch
    from repro_torch import bridge, core
    from repro_torch.core.while_loop import SAVE_POLICIES
    from repro_torch.models import rnn

    B, D, H = 512, 512, 512
    gen = torch.Generator(device="cuda").manual_seed(2)
    grad_ms = {}
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
        grad_ms[S] = policies_graph(x, S, grads["all"])
        del x, grads
    for policy in SAVE_POLICIES:
        ratio = grad_ms[500][policy][1] / grad_ms[100][policy][1]
        log(f"[policy] graph {policy}: gradient loop ms per iteration "
            f"S=500 / S=100 = {ratio:.3f} (bound 1.2: the duals touch one "
            f"row an iteration)")
        if ratio > 1.2:
            raise AssertionError(f"the gradient loop's work per iteration "
                                 f"grows with S under {policy}: {ratio:.3f}")
    fig2_graph()


def policies_graph(x, S, ref):
    """Table 1 under the graph lowering (``impl="graph"``): the four
    policies at this S, each loop captured by its first call (device
    memory counted from before it, so the stacks show in the peak) and
    timed on its second, forward and gradient launches apart. The
    gradients must equal the host lowering's ``all`` (``ref``) at rtol
    1e-6, one capture and four launches in two passes; ``offload`` must
    hold S x ``residual_bytes`` in host memory, ``carry_offload`` S x
    ``carry_bytes``, the others none. At S=500 the offloading policies
    peak below their device twins, and ``all``'s gradient loop (the
    recorded body's backward from popped residuals) takes fewer ms an
    iteration than ``carry``'s (which re-runs the body's forward).
    Returns (forward, gradient loop) ms per iteration by policy."""
    import torch
    from repro_torch import bridge, core
    from repro_torch.core import device_grad
    from repro_torch.core.device_grad import GradLoop
    from repro_torch.core.while_loop import SAVE_POLICIES
    from repro_torch.models import rnn

    B, D, H = x.shape[0], x.shape[2], 512
    peaks, out_ms = {}, {}
    for policy in SAVE_POLICIES:
        device_grad.release()
        params = bridge.init_lstm_params(D, H, seed=3, device="cuda")
        for p in params.values():
            p.requires_grad_()

        def forward():
            out, _ = rnn.dynamic_rnn(params, x, hidden=H,
                                     save_policy=policy, impl="graph")
            return (out ** 2).mean()

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cap0, rep0 = GradLoop.captures, GradLoop.replays
        torch.autograd.grad(forward(), [params["w"], params["b"]])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = forward()
        ev[1].record()
        g = torch.autograd.grad(loss, [params["w"], params["b"]])
        ev[2].record()
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated() - base
        loop = core.while_loop.last_grad_loop
        captures, launches = (GradLoop.captures - cap0,
                              GradLoop.replays - rep0)
        fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        out_ms[policy] = (fwd_ms / S, bwd_ms / S)
        pushed = loop.residual_bytes or loop.carry_bytes
        what = "residual_bytes" if loop.residual_bytes else "carry_bytes"
        want_host = S * pushed if policy.endswith("offload") else 0
        err = max((a - r).abs().max().item() for a, r in zip(g, ref))
        ok = all(torch.allclose(a, r, rtol=1e-6, atol=1e-9)
                 for a, r in zip(g, ref))
        log(f"[policy] S={S} graph {policy:13s}: {(fwd_ms + bwd_ms) / S:.4f}"
            f" ms per loop iteration (forward {fwd_ms / S:.4f} + gradient "
            f"loop {bwd_ms / S:.4f}; one launch each: {launches} launches "
            f"in 2 passes, {captures} capture), pushes {pushed} B an "
            f"iteration ({what}), "
            f"peak {peaks[policy] / 2**30:.3f} GiB above weights and "
            f"inputs (static buffers and stacks included), "
            f"{loop.host_bytes / 2**30:.3f} GiB of host stacks "
            f"({loop.host_bytes} B), gradients vs host all: max |diff| "
            f"{err:.3e} (tol rtol 1e-6) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"graph {policy} gradients differ from "
                                 f"the host lowering's all")
        if captures != 1 or launches != 4 or loop.host_bytes != want_host:
            raise AssertionError(
                f"graph {policy}: captures {captures} (want 1), launches "
                f"{launches} (want 4), host bytes {loop.host_bytes} (want "
                f"{want_host})")
        if S == 500 and policy in ("all", "carry"):
            profile_grad_iteration(loop, f"S={S} graph {policy}",
                                   bwd_ms / S)
        del params, g, loss
    device_grad.release()
    if S == 500:
        if not (peaks["carry_offload"] < peaks["carry"]
                and peaks["offload"] < peaks["all"]):
            raise AssertionError(f"graph offloading does not peak below "
                                 f"the device stacks at S=500: {peaks}")
        if not out_ms["all"][1] < out_ms["carry"][1]:
            raise AssertionError(
                f"graph all's gradient loop ({out_ms['all'][1]:.4f} ms an "
                f"iteration) is not faster than carry's "
                f"({out_ms['carry'][1]:.4f}), which re-runs the forward")
    return out_ms


def profile_grad_iteration(loop, label, graph_ms, iters=20):
    """Where an iteration of the graph gradient loop goes: its body (the
    kernels the WHILE node replays) run eagerly ``iters`` times under
    the profiler, at the last row; device ms an iteration by kernel
    beside the WHILE node's ms an iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = (loop.j, loop.g_carry)
    with torch.no_grad():
        loop.j.zero_()
        loop._grad_body(state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                loop._grad_body(state)
            torch.cuda.synchronize()
    rows = [r for r in profile_rows(prof)
            if r.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(r.self_device_time_total for r in rows) / iters / 1e3
    rows.sort(key=lambda r: -r.self_device_time_total)
    log(f"[profile] {label} gradient-loop iteration, run eagerly: "
        f"{dev:.4f} device ms in {sum(r.count for r in rows) / iters:.1f} "
        f"kernels (the WHILE node {graph_ms:.4f} ms an iteration); by "
        f"kernel, ms an iteration: " + "; ".join(
            f"{r.self_device_time_total / iters / 1e3:.4f} "
            f"({r.count / iters:.2f} an iteration) {r.key[:60]}"
            for r in rows[:8]))


def fig2_graph():
    """Fig. 2's functionals in the graph: ``scan`` (forward and reverse)
    under ``impl="graph"`` on the card at a small size, under ``all``
    and ``offload``, against ``impl="host"``: results and gradients
    within rtol 1e-6, one capture and two launches a pass."""
    import torch
    from repro_torch import core
    from repro_torch.core import device_grad
    from repro_torch.core.device_grad import GradLoop

    gen = torch.Generator(device="cuda").manual_seed(4)
    xs = torch.randn(64, 32, 128, generator=gen, device="cuda")
    w0 = torch.randn(128, 128, generator=gen, device="cuda") * 0.05
    h0 = torch.zeros(32, 128, device="cuda")

    def run(policy, impl, reverse):
        w = w0.clone().requires_grad_()
        e = xs.clone().requires_grad_()
        ys = core.scan(lambda c, x: torch.tanh(c @ w + x), e, h0,
                       reverse=reverse, save_policy=policy, impl=impl)
        return (ys.detach(), *torch.autograd.grad((ys ** 2).sum(), [w, e]))

    for policy in ("all", "offload"):
        for reverse in (False, True):
            ref = run(policy, "host", reverse)
            cap0, rep0 = GradLoop.captures, GradLoop.replays
            for _ in range(2):
                ours = run(policy, "graph", reverse)
            torch.cuda.synchronize()
            loop = core.while_loop.last_grad_loop
            captures, launches = (GradLoop.captures - cap0,
                                  GradLoop.replays - rep0)
            err = max((a - r).abs().max().item() for a, r in zip(ours, ref))
            ok = all(torch.allclose(a, r, rtol=1e-6, atol=1e-7)
                     for a, r in zip(ours, ref))
            log(f"[fig2] scan(impl='graph', save_policy={policy!r}, "
                f"reverse={reverse}) over 64 x (32, 128): max |graph - "
                f"host| {err:.3e} (rtol 1e-6) {'ok' if ok else 'FAIL'}; "
                f"{captures} capture, {launches} launches in 2 passes; "
                f"residual_bytes {loop.residual_bytes}, host bytes "
                f"{loop.host_bytes}")
            if not ok or captures != 1 or launches != 4:
                raise AssertionError(
                    f"scan under the graph lowering ({policy}, reverse "
                    f"{reverse}): agreement {ok}, captures {captures} "
                    f"(want 1), launches {launches} (want 4)")
            device_grad.release()


def flagged_lstm(params, x, flags, impl, policy):
    """Table 1's LSTM step where ``flags[t]`` is set and the state carried
    through where not: ``cond(flags.read(t) != 0, step, carry through)``
    in a counted loop over t, graph (``backend="graph"``, device arrays)
    or host (``backend="native"``, a host read a step). Returns (c, h)."""
    import torch
    from repro_torch import core
    from repro_torch.models import rnn
    B, S, _ = x.shape
    H = params["b"].shape[0] // 4
    graph = impl == "graph"
    ta = core.DeviceTensorArray if graph else core.TensorArray
    xs = ta.unstack(x.transpose(0, 1).contiguous())
    fl = ta.unstack(flags)

    def step(c, h, xt):
        _, (c2, h2) = rnn.lstm_cell(params, xt, (c, h))
        return c2, h2

    def body(s):
        t, c, h = s
        c, h = core.cond(fl.read(t) != 0, step, lambda c, h, xt: (c, h), c,
                         h, xs.read(t),
                         backend="graph" if graph else "native")
        return (t + 1, c, h)

    zeros = torch.zeros(B, H, device=x.device)
    t0 = torch.zeros((), dtype=torch.long, device=x.device) if graph else 0
    _, c, h = core.while_loop(None, body, (t0, zeros, zeros), max_iters=S,
                              save_policy=policy, impl=impl)
    return c, h


def parents_program(policy):
    """The JAX package's ``test_cond_in_while_grad`` program,
    ``cond(i % 2 == 0, y * w, y + 1)`` four times, under
    ``while_loop(impl="graph")``: (y, dy/dw, dy/dx) and the reference."""
    import torch
    from repro_torch import core
    w = torch.tensor(1.5, device="cuda", requires_grad=True)
    x = torch.tensor(2.0, device="cuda", requires_grad=True)

    def b(c):
        i, y = c
        return (i + 1, core.cond(i % 2 == 0, lambda v: v * w,
                                 lambda v: v + 1.0, y, backend="graph"))
    y = core.while_loop(lambda c: c[0] < 4, b,
                        (torch.zeros((), dtype=torch.long, device="cuda"),
                         x), max_iters=4, save_policy=policy,
                        impl="graph")[1]
    got = (y.item(), *[g.item() for g in torch.autograd.grad(y, [w, x])])
    return got, ((2.0 * 1.5 + 1) * 1.5 + 1, 2 * 2.0 * 1.5 + 1, 1.5 ** 2)


def phase_graph_cond():
    """§5.1's gradient of a cond on the device: the flagged LSTM body at
    B=512, D=H=512, S=500, fp32 (flags ~50% ones), under the four graph
    policies against the host lowering under ``all``: gradients of w, b
    and x, two graph launches a pass, no host read added by a pass (the
    predicates stay on the device), ms an iteration at 50% flags, and
    under ``all`` and ``carry`` at 100% (the same captured loop, flags
    reloaded). Then the JAX test's program under ``carry``."""
    import torch
    from repro_torch import bridge, core
    from repro_torch.core import device_grad
    from repro_torch.core.device_grad import GradLoop
    from repro_torch.core.device_loop import DeviceLoop
    from repro_torch.core.while_loop import SAVE_POLICIES

    B, S, D, H = 512, 500, 512, 512
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(B, S, D, generator=gen, device="cuda",
                    requires_grad=True)
    half = (torch.rand(S, generator=gen, device="cuda") < 0.5).int()
    ones = torch.ones(S, dtype=torch.int32, device="cuda")
    params = bridge.init_lstm_params(D, H, seed=7, device="cuda")
    for p in params.values():
        p.requires_grad_()
    set_ = int(half.sum())

    def grads(impl, policy, flags):
        c, h = flagged_lstm(params, x, flags, impl, policy)
        loss = (h ** 2).mean() + (c * h).mean()
        return torch.autograd.grad(loss, [params["w"], params["b"], x])

    def timed_pass(policy, flags):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        g = grads("graph", policy, flags)
        ev[1].record()
        torch.cuda.synchronize()
        return g, ev[0].elapsed_time(ev[1]) / S

    ref = grads("host", "all", half)
    torch.cuda.synchronize()
    ms = {}
    for policy in SAVE_POLICIES:
        device_grad.release()
        grads("graph", policy, half)              # warm-up and captures
        launches, reads = GradLoop.replays, DeviceLoop.host_reads
        loop_reads = core.while_loop.host_reads
        g, ms[policy, 50] = timed_pass(policy, half)
        added = (GradLoop.replays - launches,
                 DeviceLoop.host_reads - reads,   # every read_host transfer
                 core.while_loop.host_reads - loop_reads)
        if policy in ("all", "carry"):
            _, ms[policy, 100] = timed_pass(policy, ones)
        err = [(a - r).abs().max().item() for a, r in zip(g, ref)]
        ok = all(torch.allclose(a, r, rtol=1e-5, atol=1e-7)
                 for a, r in zip(g, ref))
        log(f"[cond-grad] S={S} flags set {set_}/{S}, graph {policy:13s}: "
            f"max |graph - host all| w {err[0]:.3e} b {err[1]:.3e} x "
            f"{err[2]:.3e} (rtol 1e-5) {'ok' if ok else 'FAIL'}; "
            f"{added[0]} graph launches a pass, host reads added by a "
            f"pass {added[1]} (device loop) {added[2]} (while_loop); "
            f"{ms[policy, 50]:.4f} ms an iteration at 50% flags"
            + (f", {ms[policy, 100]:.4f} at 100%" if (policy, 100) in ms
               else ""))
        if not ok or added != (2, 0, 0):
            raise AssertionError(
                f"cond under grad, {policy}: agreement {ok}, (launches, "
                f"device-loop reads, while_loop reads) a pass {added}, want "
                f"(2, 0, 0)")
        device_grad.release()
    for policy in ("all", "carry"):
        log(f"[cond-grad] {policy}: the 50% pass takes "
            f"{ms[policy, 50] / ms[policy, 100]:.3f} of the 100% pass "
            f"(flags set {set_}/{S})")
    got, want = parents_program("carry")
    device_grad.release()
    log(f"[cond-grad] the JAX test's program cond(i % 2 == 0, y * w, y + 1) "
        f"under carry: y {got[0]:.6f} dy/dw {got[1]:.6f} dy/dx "
        f"{got[2]:.6f} (reference {want[0]:.6f} {want[1]:.6f} "
        f"{want[2]:.6f})")
    if max(abs(a - b) for a, b in zip(got, want)) > 1e-5:
        raise AssertionError(f"cond under grad: {got} for {want}")


def stacked_fns(w, b, impl, inner="all", cell=None):
    """The predicate and body of an outer ``while_loop`` over the layers
    of a stacked LSTM, weights (L, D+H, 4H) read at its counter, whose
    body runs one ``dynamic_rnn`` (carry: (layer, inputs))."""
    import torch
    from repro_torch.models import rnn
    H = b.shape[1] // 4
    cell = rnn.lstm_cell if cell is None else cell

    def cond_fn(s):
        return s[0] < w.shape[0]

    def body_fn(s):
        l, y = s
        ix = l.reshape(1) if torch.is_tensor(l) else l
        p = {"w": w[ix].reshape(w.shape[1:]), "b": b[ix].reshape(b.shape[1:])}
        out, _ = rnn.dynamic_rnn(p, y, hidden=H, save_policy=inner,
                                 impl=impl, cell=cell)
        return (l + 1, out)

    return cond_fn, body_fn


def stacked_lstm(w, b, x, impl, outer="all", inner="all"):
    """The stacked LSTM's last layer outputs, the outer loop under
    ``outer`` and each layer's under ``inner``."""
    import torch
    from repro_torch import core
    cond_fn, body_fn = stacked_fns(w, b, impl, inner)
    l0 = (torch.zeros((), dtype=torch.long, device=x.device)
          if impl == "graph" else 0)
    return core.while_loop(cond_fn, body_fn, (l0, x), max_iters=w.shape[0],
                           save_policy=outer, impl=impl)[1]


def phase_graph_nested():
    """A graph loop in a graph loop. Forward: L=4 stacked layers of
    Table 1's LSTM (B=512, D=H=512, S=1000, fp32) through the fused
    ``lstm_cell`` kernel as one outer WHILE node over nested WHILE
    nodes, bit-equal to ``multilayer_dynamic_rnn(impl="graph")`` (a
    graph loop a layer), one launch a pass and L x S kernel launches
    counted on the device. Under grad: L=2, S=100, outer ``carry``, the
    layers' loops under each policy, against ``impl="host"``."""
    import functools
    import torch
    from repro_torch import bridge, core, kernels
    from repro_torch.core import device_grad, device_loop
    from repro_torch.core.device_grad import GradLoop
    from repro_torch.core.device_loop import DeviceLoop
    from repro_torch.core.while_loop import SAVE_POLICIES
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.models import rnn

    def weights(L, D, H, grad=False):
        ps = [bridge.init_lstm_params(D, H, seed=8 + k, device="cuda")
              for k in range(L)]
        w = torch.stack([p["w"] for p in ps]).requires_grad_(grad)
        b = torch.stack([p["b"] for p in ps]).requires_grad_(grad)
        return w, b, ps

    L, B, S, D = 4, 512, 1000, 512
    w, b, ps = weights(L, D, D)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x0 = torch.randn(B, S, D, generator=gen, device="cuda")
    fused = functools.partial(rnn.lstm_cell, kernel=lstm_ops.lstm_cell)
    counts = torch.zeros(1, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = rnn.multilayer_dynamic_rnn(ps, x0, hidden=D, impl="graph",
                                         cell=fused)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = rnn.multilayer_dynamic_rnn(ps, x0, hidden=D, impl="graph",
                                         cell=fused)
        torch.cuda.synchronize()
        layer_s = time.perf_counter() - t1
        first_s = t1 - t0
        # the loop's functions and carry held, so the second pass replays
        cond_fn, body_fn = stacked_fns(w, b, "graph", cell=fused)
        carry = (torch.zeros((), dtype=torch.long, device="cuda"),
                 x0.clone())

        def restart(s):
            s[0].zero_()

        def nested_pass():
            core.while_loop(cond_fn, body_fn, carry, max_iters=L,
                            impl="graph", prologue=restart)

        cap0 = DeviceLoop.captures
        with kernels.device_launch_counts(counts, ("lstm_cell",)):
            nested_pass()                                  # captures
        torch.cuda.synchronize()
        counts.zero_()
        x = carry[1]
        x.copy_(x0)
        launches, reads = DeviceLoop.replays, DeviceLoop.host_reads
        t0 = time.perf_counter()
        nested_pass()
        torch.cuda.synchronize()
        nested_s = time.perf_counter() - t0
    launched = DeviceLoop.replays - launches
    added = DeviceLoop.host_reads - reads
    on_device = int(counts.item())
    same = torch.equal(x, ref)
    err = (x - ref).abs().max().item()
    device_loop.release(body_fn)
    log(f"[nested] forward L={L} B={B} S={S} D=H={D} fp32, fused cell: one "
        f"outer WHILE over nested WHILE nodes, {DeviceLoop.captures - cap0} "
        f"capture, {launched} graph launch a pass, {on_device} lstm_cell "
        f"launches counted on the device (L x S = {L * S}), host reads a "
        f"pass {added} (the nested arrays' write-once check); bit-equal to "
        f"a graph loop a layer: {same} (max |diff| {err:.3e}); {nested_s:.3f}"
        f" s a pass ({nested_s / (L * S) * 1e3:.4f} ms a step) vs "
        f"{layer_s:.3f} s for {L} launches (first pass with its captures "
        f"{first_s:.3f} s)")
    if not same or launched != 1 or on_device != L * S:
        raise AssertionError(f"nested forward: bit-equal {same}, launches "
                             f"{launched} (want 1), lstm_cell on the device "
                             f"{on_device} (want {L * S})")
    del x, x0, ref
    device_grad.release()

    L, S = 2, 100
    gen = torch.Generator(device="cuda").manual_seed(10)
    xg = torch.randn(B, S, D, generator=gen, device="cuda")

    def grads(impl, inner):
        w, b, _ = weights(L, D, D, grad=True)
        xx = xg.clone().requires_grad_()
        y = stacked_lstm(w, b, xx, impl, outer="carry", inner=inner)
        return torch.autograd.grad((y ** 2).mean(), [w, b, xx])

    for inner in SAVE_POLICIES:
        ref = grads("host", inner)
        grads("graph", inner)                       # captures
        torch.cuda.synchronize()
        launches = GradLoop.replays
        t0 = time.perf_counter()
        g = grads("graph", inner)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = GradLoop.replays - launches
        errs = [(a - r).abs().max().item() for a, r in zip(g, ref)]
        ok = all(torch.allclose(a, r, rtol=1e-5, atol=1e-7)
                 for a, r in zip(g, ref))
        log(f"[nested] grad L={L} S={S} outer carry, inner {inner:13s}: "
            f"max |graph - host| w {errs[0]:.3e} b {errs[1]:.3e} x "
            f"{errs[2]:.3e} (rtol 1e-5) {'ok' if ok else 'FAIL'}; "
            f"{launched} graph launches a pass; {secs * 1e3:.1f} ms a pass")
        if not ok or launched != 2:
            raise AssertionError(f"nested gradient, inner {inner}: "
                                 f"agreement {ok}, launches {launched} "
                                 f"(want 2)")
        device_grad.release()


def phase_nmt():
    """The NMT example's entry point, 250 steps on the card under the
    graph lowering and its default save policy (``all``, the body's
    residuals on device stacks); it raises if the loss does not fall
    below 0.5. Both loops are captured once (the first step) and each
    step launches four graphs (two forwards, two gradient loops)."""
    from repro_torch import core
    from repro_torch.core import device_grad
    from repro_torch.core.device_grad import GradLoop
    from repro_torch.examples import dynamic_rnn_nmt as nmt
    cap0, rep0 = GradLoop.captures, GradLoop.replays
    t0 = time.perf_counter()
    loss = nmt.main(["--steps", str(nmt.STEPS)])
    secs = time.perf_counter() - t0
    captures, launches = GradLoop.captures - cap0, GradLoop.replays - rep0
    loop = core.while_loop.last_grad_loop
    policy, pushed = loop.policy, loop.residual_bytes
    device_grad.release()
    log(f"[nmt] {nmt.STEPS} steps on the card under impl='graph', "
        f"save_policy {policy!r} (the decoder pushes {pushed} B of "
        f"residuals an iteration): final masked NLL {loss:.4f} (bar "
        f"{nmt.LOSS_BAR}); {captures} captures, {launches} graph launches "
        f"({launches / nmt.STEPS:.0f} a step); "
        f"{secs / nmt.STEPS * 1e3:.2f} ms a step")
    if policy != "all" or not pushed:
        raise AssertionError(f"NMT under the graph lowering ran save_policy "
                             f"{policy!r}, pushing {pushed} B of residuals; "
                             f"its default is 'all'")
    if captures != 2 or launches != 4 * nmt.STEPS:
        raise AssertionError(f"NMT under the graph lowering: {captures} "
                             f"captures (want 2), {launches} launches (want "
                             f"{4 * nmt.STEPS})")
    nmt_policies(nmt)


def nmt_policies(nmt, steps=50):
    """Warm NMT steps under the graph lowering, ``carry`` against
    ``all`` in turns (carry, all, all, carry; the first step of each run
    untimed): host ms a step, and device ms a step of the four graph
    launches (CUDA events around ``DeviceLoop.run``)."""
    import torch
    from repro_torch.core import device_grad, device_loop

    run = device_loop.DeviceLoop.run
    events = []

    def timed(self):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        out = run(self)
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        events.append((a, b))
        return out

    got = {}
    for policy in ("carry", "all", "all", "carry"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = nmt.init(gen)
        cfg = nmt.adamw.AdamWConfig(lr=nmt.LR, weight_decay=0.0)
        opt = nmt.adamw.init(params)
        data = [nmt.batch(gen) for _ in range(steps + 1)]
        params, opt, _ = nmt.train_step(cfg, params, opt, *data[0],
                                        save_policy=policy, impl="graph")
        torch.cuda.synchronize()
        events.clear()
        device_loop.DeviceLoop.run = timed
        try:
            t0 = time.perf_counter()
            for b in data[1:]:
                params, opt, _ = nmt.train_step(cfg, params, opt, *b,
                                                save_policy=policy,
                                                impl="graph")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
        finally:
            device_loop.DeviceLoop.run = run
        dev = sum(a.elapsed_time(b) for a, b in events) / steps
        got.setdefault(policy, []).append((wall, dev))
        device_grad.release()
    log("[nmt] warm steps under the graph lowering, in turns carry, all, "
        "all, carry: " + "; ".join(
            f"{p} {', '.join(f'{w:.3f}' for w, _ in v)} ms a step (the four "
            f"launches {', '.join(f'{d:.3f}' for _, d in v)} device ms)"
            for p, v in got.items()))


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
    record["shapes"] = [time_flash_shape(kern, sdpa, "qwen2-moe-a2.7b",
                                         FA_MOE, 400),
                        time_flash_shape(kern, sdpa, "zamba2-1.2b",
                                         FA_ZAMBA, 500)]
    return record


def time_flash_shape(kern, sdpa, arch, shape, seed):
    """The flash kernel at a model's forward (qwen2-moe-a2.7b: G = 1, D =
    128; zamba2-1.2b's shared block: G = 1, D = 64), bf16 causal, held
    against its plain version and timed beside SDPA: an extra ``shapes``
    entry of its record."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    copies = [fa_case(seed + i, *shape, torch.bfloat16) for i in range(4)]
    ref = attention_ref(*copies[0])
    err, need, ok = fa_check(kern(*copies[0]), ref)
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {shape}: {need:.3e}")
    heads = [[t.transpose(1, 2) for t in c] for c in copies]
    times = call_times(lambda i: kern(*copies[i]), len(copies),
                       lambda i: sdpa(*heads[i], is_causal=True,
                                      enable_gqa=True), iters=20)
    plain_ms = time_ms(lambda i: attention_ref(*copies[i]), len(copies),
                       iters=5)
    b_ms, b_by = fa_bound(*copies[0])
    log(f"[flash] time flash_attention at {arch}'s "
        f"B,S,H,KV,D={shape} bf16 causal: {fmt_times(times)}, plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), device "
        f"kernel/sdpa {times['ms'] / times['library_ms']:.2f}, max |kernel "
        f"- plain| {err:.3e} (atol needed {need:.3e})")
    return {"arch": arch, "B,S,H,KV,D": list(shape),
            "max_abs_err": err, "ms": times["ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times["library_ms"],
            "eager_ms": times["eager_ms"],
            "library_eager_ms": times["library_eager_ms"]}


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
    from unittest import mock
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import bridge, core
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

        # The checkpoint is restored once, by the second launch's
        # resume, and held there to the first launch's final state
        # (13.8 GiB kept on the card: the second launch's step peaks at
        # about 49 GiB beside it).
        final = pytree.tree_leaves({"params": res["params"],
                                    "opt": res["opt"]})
        del res
        gc.collect()
        torch.cuda.empty_cache()
        seen = {}
        resume = train_loop.Trainer.maybe_resume

        def held_resume(trainer, params, opt_state, shardings=None):
            t0 = time.perf_counter()
            step, params, opt_state = resume(trainer, params, opt_state,
                                             shardings)
            torch.cuda.synchronize()
            seen["secs"] = time.perf_counter() - t0
            state = pytree.tree_leaves({"params": params, "opt": opt_state})
            seen["step"], seen["leaves"] = step, len(state)
            seen["same"] = len(state) == len(final) and all(
                torch.equal(a, b) if torch.is_tensor(a) else a == b
                for a, b in zip(state, final))
            return step, params, opt_state

        with mock.patch.object(train_loop.Trainer, "maybe_resume",
                               held_resume):
            again = launch_train.main(argv + ["--steps",
                                              str(TRAIN_STEPS + 2)])
        del final
        log(f"[train] checkpoint step {seen['step']} restored in "
            f"{seen['secs']:.1f} s by the second launch: "
            f"{'bit-equal' if seen['same'] else 'DIFFERS'} to the first "
            f"launch's final state ({seen['leaves']} leaves)")
        if seen["step"] != TRAIN_STEPS or not seen["same"]:
            raise AssertionError("the checkpoint does not restore exactly")
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


def card_label():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_dqn():
    """The paper's §6.5 DQN (``examples.dqn_in_graph.dqn_rows``): the
    same 200 steps from the same carry in-graph (a), out-of-graph (b)
    and eager (c), in turns; (a) must be one graph launch and no host
    read, and its final carry must equal (c)'s (the key, ``t`` and the
    actions exactly, floats within DQN_TOL). Then the example's ``main``
    through the graph lowering must improve the return."""
    from repro_torch.examples import dqn_in_graph as dqn
    smi = card_label()
    rows = dqn.dqn_rows()
    names = {"a": "in-graph (one WHILE-node launch)",
             "b": "out-of-graph (a captured step a launch)",
             "c": "eager (native conds)"}
    for k, name in names.items():
        r = rows[k]
        log(f"[dqn] {smi}: ({k}) {name}: host us/step "
            + ", ".join(f"{v:.1f}" for v in r["host_us"])
            + "; device us/step "
            + ", ".join(f"{v:.1f}" for v in r["device_us"])
            + f"; graph launches/step {r['graph_launches']:.4f}, kernel "
            f"launches a training step {r['kernel_launches']:.1f}, host "
            f"reads/step {r['host_reads']:.2f}")
    log(f"[dqn] {smi}: (b)/(a) - 1 = {rows['speedup_percent']:.1f}% (the "
        f"paper reports 21%); (c)/(a) = {rows['c_over_a']:.2f}x")
    a = rows["a"]
    if a["graph_launches"] * dqn.STEPS != 1 or a["host_reads"] != 0:
        raise AssertionError(f"dqn: in-graph run made "
                             f"{a['graph_launches'] * dqn.STEPS} launches "
                             f"and {a['host_reads'] * dqn.STEPS} host reads")
    for k in ("a", "b"):
        diff = dqn.same_carry(rows[k]["carry"], rows["c"]["carry"], DQN_TOL)
        if diff is not None:
            raise AssertionError(f"dqn: ({k}) against eager: {diff}")
    out = dqn.main([])
    log(f"[dqn] main on the card: return/step {out['pre']:.4f} -> "
        f"{out['post']:.4f} after {out['t']} training steps in one launch")


def phase_examples():
    """``quickstart`` on the card against the CPU (QUICK_TOL);
    ``train_lm --full`` (smollm-135m, published width) 20 steps, then
    ``--in-graph 10`` for 20 steps, the loss finite and falling; and
    ``elastic_restart`` phases 1-2 at that width (max |difference| <
    1e-5)."""
    import math
    from repro_torch.examples import elastic_restart, quickstart, train_lm
    smi = card_label()
    gpu, cpu = quickstart.main([]), quickstart.main(["--device", "cpu"])
    for k, want in cpu.items():
        got = gpu[k]
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            if abs(g - w) > QUICK_TOL * max(1.0, abs(w)):
                raise AssertionError(f"quickstart {k}: card {got} cpu {want}")
    log("[examples] quickstart: the card's values equal the CPU's within "
        f"{QUICK_TOL}")
    for extra in ([], ["--in-graph", "10"]):
        r = train_lm.main(["--full", "--steps", "20"] + extra)
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"train_lm {extra}: losses {losses}")
        log(f"[examples] {smi}: train_lm --full {' '.join(extra)}: "
            f"{r['ms_per_step']:.2f} ms a step ({r['lowering']}), loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        del r
    # phase 3 (8 gloo CPU ranks restoring onto a (4, 2) mesh) runs in the
    # CPU tests; phase 41 restores a sharded run on the card
    e = elastic_restart.main(["--full", "--no-mesh-restore"])
    log(f"[examples] elastic_restart --full: max |difference| "
        f"{e['max_diff']:.3e} (exactly 0: {e['max_diff'] == 0})")


DISAGG_SLOTS, DISAGG_PREFILL_SLOTS = 8, 2
DISAGG_BUDGETS = (6, 10, 14, 18, 22)


def disagg_requests(n=32, short=8, long=512):
    """``bench_disagg._workload``: 7 short prompts to 1 long, the budgets
    6-22 in turn (numpy seed 0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [(rng.integers(2, 512, (1, long if i % 8 == 3 else short)
                          ).astype(np.int32),
             DISAGG_BUDGETS[i % len(DISAGG_BUDGETS)]) for i in range(n)]


def make_disagg(params, cfg, **kw):
    from repro_torch.serve import disagg as disagg_lib
    args = dict(n_prefill_slots=DISAGG_PREFILL_SLOTS,
                n_decode_slots=DISAGG_SLOTS, prompt_len=512,
                max_new_cap=max(DISAGG_BUDGETS), eos_id=-1, kv_block=16,
                chunk_tokens=128, segment_steps=8)
    return disagg_lib.DisaggScheduler(params, cfg, **{**args, **kw})


def segment_windows(sched):
    """Record CUDA timing events around each of ``sched``'s segment
    launches, on the stream it launches on, and the host's clock at the
    launch; returns the list they go to, as (start, end, host seconds)
    triples."""
    import torch
    wins, launch = [], sched._segment

    def timed_segment(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        launch(*args, **kw)
        end.record()
        wins.append((start, end, t))
    sched._segment = timed_segment
    return wins


def busy_ms(ref, wins):
    """The union of the windows (ms after ``ref``), as sorted disjoint
    intervals."""
    spans = sorted((ref.elapsed_time(w[0]), ref.elapsed_time(w[1]))
                   for w in wins)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_ms(xs, ys):
    """Total length of the intersection of two sets of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def gap_run(sched, reqs, delivery, tiers=()):
    """``bench_disagg._drive``'s closed loop and round accounting, from
    the host mirrors (no read of its own): every request submitted at
    once, ``step(expect_arrivals=True)`` until drained; a round's wall
    spreads over its delivery-tier iterations, a round without one
    carries its wall into the next gap, a request's first token is not a
    gap. ``delivery`` is the scheduler whose iterations are the clock;
    each of ``tiers`` has its segments' device windows recorded. Returns
    tok/s, the gaps' p50/p99 (ms), rounds, the streams, and each tier's
    busy intervals (ms from the start)."""
    import numpy as np
    import torch
    wins = [segment_windows(t) for t in tiers]
    ref = torch.cuda.Event(enable_timing=True)
    for rid, (prompt, max_new) in enumerate(reqs):
        sched.submit(prompt, max_new=max_new, request_id=rid)
    seen, gaps, streams = {}, [], {}
    stall, rounds = 0.0, 0
    torch.cuda.synchronize()
    ref.record()
    t0 = time.perf_counter()
    steps_prev = delivery.total_steps
    while sched.pending:
        ts = time.perf_counter()
        fin = sched.step(expect_arrivals=True)
        rounds += 1
        wall = time.perf_counter() - ts
        k = delivery.total_steps - steps_prev
        steps_prev = delivery.total_steps
        for f in fin:
            streams[f.request_id] = f.tokens
        if k == 0:
            stall += wall
            continue
        per = wall / k
        now = {rid: len(t) for rid, t in sched.resident().items()}
        now.update({f.request_id: f.length for f in fin})
        for rid, n in now.items():
            if rid not in seen:
                seen[rid] = n
                if n > 1:
                    gaps.extend([per] * (n - 1))
                continue
            d = n - seen[rid]
            if d <= 0:
                continue
            if seen[rid] > 0:
                gaps.append(stall + per)
                gaps.extend([per] * (d - 1))
            elif d > 1:
                gaps.extend([per] * (d - 1))
            seen[rid] = n
        stall = 0.0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for t in tiers:
        del t._segment                   # the class's method again
    g = np.asarray(gaps) * 1e3
    return {"tok_s": sum(len(t) for t in streams.values()) / wall,
            "p50_ms": float(np.percentile(g, 50)),
            "p99_ms": float(np.percentile(g, 99)), "rounds": rounds,
            "streams": streams, "wall_s": wall,
            "busy": [busy_ms(ref, w) for w in wins],
            "launch_gap_ms": launch_gap(wins)}


def launch_gap(wins):
    """With two tiers: the mean host time from each prefill-tier segment
    launch to the next decode-tier launch, and the prefill segments'
    mean device time (ms); None otherwise."""
    if len(wins) != 2 or not wins[0]:
        return None
    decode = sorted(t for _, _, t in wins[1])
    gaps = [next((d for d in decode if d > t), t) - t for _, _, t in wins[0]]
    dev = [a.elapsed_time(b) for a, b, _ in wins[0]]
    return 1e3 * sum(gaps) / len(gaps), sum(dev) / len(dev)


def stream_overlap():
    """Whether two graphs launched back to back on two streams run at
    once on the card: 2,000 iterations of ``x = tanh(x @ w)``, x (64,
    1024), w (1024, 1024), fp32, captured as a plain CUDA graph, and as
    ``while_loop(impl="graph")`` (a WHILE node), one per stream. Returns
    {lowering: (ms each alone, ms both, ms both in flight at once)}."""
    import torch
    from repro_torch import core
    from repro_torch.core import device_loop
    n = 2000
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(1024, 1024, generator=gen) / 32).cuda()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    carries = [(torch.randn(64, 1024, generator=gen).cuda(),
                torch.zeros((), dtype=torch.int32, device="cuda"))
               for _ in streams]
    plain = []
    with torch.no_grad():
        for c in carries:
            for _ in range(3):                  # cuBLAS warm-up
                torch.tanh(c[0] @ w)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                x = c[0]
                for _ in range(n):
                    x = torch.tanh(x @ w)
                c[0].copy_(x)
            plain.append(g)

    def loop_fns():
        """A predicate, body and prologue of their own: the graph
        lowering keeps one captured loop for each set of functions."""
        return (lambda c: c[1] < n,
                lambda c: (torch.tanh(c[0] @ w), c[1] + 1),
                lambda c: c[1].zero_())

    fns = [loop_fns() for _ in streams]

    def while_on(i):
        cond_fn, body_fn, restart = fns[i]
        core.while_loop(cond_fn, body_fn, carries[i], impl="graph",
                        prologue=restart)

    out = {}
    with torch.no_grad():
        for i in range(2):                      # capture both loops
            with torch.cuda.stream(streams[i]):
                while_on(i)
        torch.cuda.synchronize()
        for name, launch in (("plain graph", lambda i: plain[i].replay()),
                             ("WHILE node", while_on)):
            alone = []
            for i in range(2):
                wins = []
                with torch.cuda.stream(streams[i]):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch(i)
                    b.record()
                b.synchronize()
                alone.append(a.elapsed_time(b))
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            torch.cuda.synchronize()
            wins = []
            for i in range(2):
                with torch.cuda.stream(streams[i]):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch(i)
                    b.record()
                    wins.append([(a, b)])
            torch.cuda.synchronize()
            spans = [busy_ms(ref, wn) for wn in wins]
            both = max(b for (_, b) in spans[0] + spans[1]) - \
                min(a for (a, _) in spans[0] + spans[1])
            out[name] = (sum(alone) / 2, both, overlap_ms(*spans))
    for _, body_fn, _ in fns:
        device_loop.release(body_fn)
    return out


def phase_disagg():
    """Prefill/decode disaggregation at llama3.2-1b full width, bf16: the
    2-slot prefill tier and 8-slot decode tier against the colocated
    8-slot scheduler, in turns, on ``bench_disagg``'s mix (32 requests,
    7:1 prompts of 8 and 512 tokens, budgets 6-22, EOS -1; block 16,
    chunk 128, segments of 8). Every request finishes, nothing gathers
    on either tier, each tier makes one host read a segment, both pools
    drain. Then in fp32: the disaggregated streams equal the colocated
    ones 32/32, and a contended decode tier preempts with no replay
    mismatch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    smi = card_label()
    cfg, params = llama_bf16()
    reqs = disagg_requests()
    colo = make_scheduler(params, cfg, max_new_cap=max(DISAGG_BUDGETS))
    dis = make_disagg(params, cfg)
    for s in (colo, dis):
        s.warmup()
        # warm both prompt widths, the ship and the splice
        for plen in (8, 512):
            s.submit(np.full((1, plen), 2, np.int32), max_new=1,
                     request_id=10_000 + plen)
            s.run_until_drained()
    runs = []
    for tag in ("colocated", "disagg", "disagg", "colocated"):
        s = colo if tag == "colocated" else dis
        r = gap_run(s, reqs, s if tag == "colocated" else s.decode,
                    [s] if tag == "colocated" else [s.prefill, s.decode])
        if len(r["streams"]) != len(reqs):
            raise AssertionError(f"disagg {tag}: {len(r['streams'])} of "
                                 f"{len(reqs)} requests finished")
        tiers = [("colocated", s)] if tag == "colocated" else \
            [("prefill tier", s.prefill), ("decode tier", s.decode)]
        for name, t in tiers:
            launches = t.device_launches
            if launches["gather"] != 0:
                raise AssertionError(f"disagg {tag} {name}: gathered")
            if t.host_reads != t.segments:
                raise AssertionError(f"disagg {tag} {name}: {t.host_reads} "
                                     f"host reads, {t.segments} segments")
            check_drained(f"disagg {tag} {name}", t)
            r[name] = (launches, t.host_reads, t.segments)
        if tag == "disagg":
            if s.decode.device_launches["paged_attention"] == 0 or \
                    s.prefill.device_launches["flash_prefill"] == 0 or \
                    s.transfers != len(reqs):
                raise AssertionError(f"disagg: kernels or shipments "
                                     f"missing ({s.transfers} transfers)")
            r["transfers"] = (s.transfers, s.transfer_bytes,
                              s.export_ms * 1e3 / max(s.transfers, 1))
        runs.append((tag, r))
        line = (f"[disagg] {smi}: {tag}: {r['tok_s']:.1f} tok/s, running-"
                f"slot gap p50/p99 {r['p50_ms']:.3f}/{r['p99_ms']:.3f} ms, "
                f"{r['rounds']} rounds")
        for name, _ in tiers:
            launches, reads, segs = r[name]
            line += (f"; {name}: {reads} host reads in {segs} segments "
                     f"({reads / r['rounds']:.3f} a round), paged_attention "
                     f"{launches['paged_attention']}, flash_prefill "
                     f"{launches['flash_prefill']}")
        busy = [sum(b - a for a, b in spans) for spans in r["busy"]]
        if tag == "disagg":
            n, b, us = r["transfers"]
            both = overlap_ms(*r["busy"])
            line += (f"; {n} transfers, {b / 1e6:.2f} MB, export "
                     f"{us:.1f} device us each ({dis.transfer_impl}); "
                     f"segments in flight: prefill tier {busy[0]:.1f} ms, "
                     f"decode tier {busy[1]:.1f} ms, both at once "
                     f"{both:.1f} ms ({both / max(min(busy), 1e-9):.3f} of "
                     f"the shorter), wall {r['wall_s'] * 1e3:.1f} ms; from "
                     f"a prefill launch to the next decode launch "
                     f"{r['launch_gap_ms'][0]:.2f} ms of host against "
                     f"{r['launch_gap_ms'][1]:.2f} ms of device for the "
                     f"prefill segment")
        else:
            line += (f"; segments in flight {busy[0]:.1f} ms of "
                     f"{r['wall_s'] * 1e3:.1f} ms wall")
        log(line)
    co = [r for t, r in runs if t == "colocated"]
    de = [r for t, r in runs if t == "disagg"]
    log(f"[disagg] {smi}: disagg/colocated tok/s "
        + ", ".join(f"{d['tok_s'] / c['tok_s']:.3f}" for d, c in
                    zip(de, co))
        + "; running-slot p99 disagg/colocated "
        + ", ".join(f"{d['p99_ms'] / c['p99_ms']:.3f}" for d, c in
                    zip(de, co)))
    same = sum(bool((runs[0][1]["streams"][i] ==
                     runs[1][1]["streams"][i]).all()) for i in range(len(reqs)))
    log(f"[disagg] bf16 streams shared by colocated and disaggregated: "
        f"{same}/{len(reqs)}")
    for name, (alone, both, at_once) in stream_overlap().items():
        log(f"[disagg] {smi}: two streams, a {name} each (2,000 "
            f"iterations of tanh(x @ w), (64, 1024) x (1024, 1024) fp32) "
            f"launched back to back: {alone:.2f} ms alone, {both:.2f} ms "
            f"both, in flight at once {at_once:.2f} ms")
    colo.close()
    dis.close()
    del colo, dis, params
    free_device_memory("the fp32 disaggregation runs")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = bridge.init_params(f32, seed=0, device="cuda")
    colo = make_scheduler(params, f32, max_new_cap=max(DISAGG_BUDGETS))
    dis = make_disagg(params, f32)
    want = fp32_streams = drive(colo, reqs)
    got = drive(dis, reqs)
    same = sum(bool((got[i] == want[i]).all()) for i in range(len(reqs)))
    if same != len(reqs):
        raise AssertionError(f"disagg fp32: {same}/{len(reqs)} streams equal")
    log(f"[disagg] fp32: disaggregated streams equal colocated "
        f"{same}/{len(reqs)}")
    colo.close()
    dis.close()
    # contention: two batch-class residents fill the decode tier, then an
    # urgent arrival must preempt (the reference test's shape, block 16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 512, (1, 48)).astype(np.int32)
               for _ in range(3)]
    tight = make_disagg(params, f32, n_prefill_slots=1, n_decode_slots=2,
                        prompt_len=48, max_new_cap=8, decode_kv_blocks=8,
                        segment_steps=2, prefill_segment_steps=4)
    tight.submit(prompts[0], max_new=8, request_id=0, priority=1)
    tight.submit(prompts[1], max_new=8, request_id=1, priority=1)
    done = []
    for _ in range(8):
        if tight.decode.active_count == 2:
            break
        done += tight.step(max_steps=1)
    if tight.decode.active_count != 2 or done:
        raise AssertionError("disagg contention: the residents did not "
                             "fill the decode tier")
    tight.submit(prompts[2], max_new=4, request_id=2, priority=0)
    done += tight.run_until_drained()
    ref = make_scheduler(params, f32, n_slots=3, prompt_len=48,
                         max_new_cap=8)
    want = drive(ref, [(prompts[0], 8), (prompts[1], 8), (prompts[2], 4)])
    got = {f.request_id: f.tokens for f in done}
    if tight.preemptions < 1 or tight.replay_mismatches != 0 or \
            any(not (got[i] == want[i]).all() for i in range(3)):
        raise AssertionError(f"disagg contention: {tight.preemptions} "
                             f"preemptions, {tight.replay_mismatches} replay "
                             f"mismatches")
    log(f"[disagg] fp32 contention: {tight.preemptions} preemption(s), "
        f"{tight.replay_mismatches} replay mismatches, streams equal the "
        f"uncontended run's 3/3")
    for s in (tight, ref):
        s.close()
    torch.cuda.synchronize()
    # what phase 40 is held to and printed beside
    return {"fp32_streams": fp32_streams,
            "colocated_tok_s": [r["tok_s"] for t, r in runs
                                if t == "colocated"],
            "disagg_tok_s": [r["tok_s"] for t, r in runs if t == "disagg"]}


# ------------------------------------------------- the MoE and VLM families

def moe_requests(cfg, n=16, prompt_len=512, max_new=64):
    """n requests of exactly ``prompt_len`` random tokens (numpy seed 0;
    MoE prompts are never padded), each ``max_new`` tokens."""
    return [(p, max_new) for p, _ in serving_requests(cfg, n, prompt_len)]


def moe_decode_bytes(cfg, positions):
    """Bytes one decode iteration of the reference's MoE must read: every
    expert's weights (each expert computes its capacity rows, used or
    not), attention, shared experts, norms, routers and the unembedding
    in bf16, and the K/V of ``positions`` cached positions. Returns
    (all, expert weights, K/V)."""
    from repro_torch.models import model_zoo
    m, L, D = cfg.moe, cfg.n_layers, cfg.d_model
    experts = L * m.n_experts * 3 * D * m.d_ff_expert * 2
    embed = cfg.padded_vocab * D * 2          # 8 rows of it are read
    other = model_zoo.count_params(cfg) * 2 - experts - embed
    kv = positions * L * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    return experts + other + kv, experts, kv


def decode_only_ms(sched, reqs, prefill_iters, iters=32):
    """Device ms of one decode iteration at 8 running slots: the requests
    admitted and prefilled in a first segment of ``prefill_iters``
    iterations, then a segment of ``iters`` decode-only iterations timed
    with CUDA events (``instrument_sync``'s start-to-read span). A
    one-shot pool admits in the first ``step`` and runs no chunk."""
    submit_all(sched, reqs)
    sched.step(max_steps=prefill_iters)
    chunks = int(sched._counts[2])
    finish = instrument_sync(sched)
    sched.step(max_steps=iters)
    _, _, _, seg_ms = finish()
    if int(sched._counts[2]) != chunks or sched.active_count != len(reqs):
        raise AssertionError("the timed segment was not decode only")
    sched.run_until_drained()
    return seg_ms / iters


def phase_moe_serve():
    """qwen2-moe-a2.7b at full width and ``MOE_SERVE_LAYERS`` layers
    (bf16, random weights from a seed, ``attn_impl="cuda"``) through the
    chunked paged scheduler: 16
    requests of exactly 512 tokens, 64 new each, EOS -1, graph segments
    against host-read ones in turns (``serve_in_turns``). Gates: every
    request finishes, both block-table kernels launch and the gather
    path never runs, one host read a segment. Prints tok/s, the device's
    share of the wall in segments, device ms an iteration, host reads a
    segment and peak memory; then a decode-only segment's device ms an
    iteration beside the bytes bound of the reference's MoE (every
    expert's weights read every iteration) and beside the top-4 share of
    the expert bytes. Returns the kernels' launches in the first graph
    run."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              attn_impl="cuda", n_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(params))
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    log(f"[moe] {cfg.name} weights {nbytes / 1e9:.2f} GB (bf16, routers "
        f"and norms fp32) drawn in {time.perf_counter() - t0:.1f} s; K/V "
        f"{kv / 1e3:.1f} KB a token")
    reqs = moe_requests(cfg)
    launches, runs = serve_in_turns(
        "moe", cfg, lambda loop: make_scheduler(params, cfg, loop), reqs,
        profile=False)
    for run in runs:
        check_kernel_path(f"moe {run['loop']}", run["launches"])
    g = runs[0]
    log(f"[moe] {cfg.name} bf16, {g['attn_impl']} / {g['prefill_impl']}, 8 "
        f"slots, chunk 128: graph run {g['tok_s']:.1f} tok/s, device in "
        f"segments {g['seg_ms'] / 1e3 / g['wall']:.3f} of the wall, "
        f"{g['seg_ms'] / g['iterations']:.3f} device ms an iteration "
        f"(chunks and decodes), {g['host_reads'] / g['segments']:.3f} host "
        f"reads a segment; launches {launches}")
    sched = make_scheduler(params, cfg)
    sched.warmup()
    ms = decode_only_ms(sched, reqs[:8], prefill_iters=4)
    sched.close()
    total, experts, kv = moe_decode_bytes(cfg, 8 * (512 + 20))
    bound = total / HBM_BYTES_PER_S * 1e3
    active = (total - experts + experts * cfg.moe.top_k
              / cfg.moe.n_experts) / HBM_BYTES_PER_S * 1e3
    log(f"[moe] decode-only iteration at 8 running slots: {ms:.3f} device "
        f"ms (graph segment, CUDA events); bytes bound {bound:.3f} ms "
        f"({total / 1e9:.2f} GB: experts {experts / 1e9:.2f} GB, K/V "
        f"{kv / 1e9:.2f} GB at 8 x 532 positions; predicted 8.5 ms), "
        f"-> at most {8 / bound * 1e3:.0f} tok/s, measured decode rate "
        f"{8 / ms * 1e3:.0f} tok/s; ms/bound {ms / bound:.2f}; were only "
        f"the top-{cfg.moe.top_k} of {cfg.moe.n_experts} experts read: "
        f"{active:.3f} ms")
    del params
    return {k: launches[k] for k in ("paged_attention", "flash_prefill")}


def phase_moe_parity():
    """qwen2-moe-a2.7b at full width cut to 4 layers, fp32: the 16
    requests of phase 27 through the kernel path in graph segments and
    the gather path in host-read segments: greedy streams must be
    identical 16/16. The routed entries dropped for capacity are counted
    from the routing maps of the host-read run's MoE calls, kept on the
    device and read once after the run: in decode every row's (the
    pool routes as one group), in a chunk the prefilling rows' only (a
    row that does not prefill runs its group on a clamped, repeated
    token and writes nothing). Then ``model_zoo.forward`` and
    ``loss_fn`` at B=1, S=512 through the flash kernel (G = 1, D = 128:
    one launch a layer) and through chunked attention: logits within
    LOGIT_TOL, the loss and aux terms within MOE_LOSS_RTOL."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.core import device_loop
    from repro_torch.models import model_zoo, moe
    from repro_torch.serve import engine

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              compute_dtype="float32",
                              n_layers=MOE_PARITY_LAYERS)
    params = bridge.init_params(cfg, seed=0, device="cuda")
    reqs = moe_requests(cfg)
    dropped = {"decode": [], "prefill": []}
    entries = {"decode": [], "prefill": []}
    route, chunk = moe.route, engine.prefill_chunk
    rows = {}

    def counted(expert_idx, E, C):
        maps = route(expert_idx, E, C)
        per_row = maps[3].sum(dim=(1, 2))
        if expert_idx.shape[0] == 1:
            kind, live = "decode", torch.ones_like(per_row)
        else:
            kind, live = "prefill", rows["mask"].long()
        dropped[kind].append((per_row * live).sum())
        entries[kind].append(live.sum() * expert_idx[0].numel())
        return maps

    def chunk_rows(*args, mask=None, **kw):
        rows["mask"] = mask
        return chunk(*args, mask=mask, **kw)

    kern = dataclasses.replace(cfg, attn_impl="cuda")
    gath = dataclasses.replace(cfg, attn_impl="gather")
    runs = parity_runs("moe-parity",
                       lambda c, loop: make_scheduler(params, c, loop), reqs,
                       [("cuda-graph", kern, None)])
    moe.route, engine.prefill_chunk = counted, chunk_rows
    try:
        runs.update(parity_runs(
            "moe-parity", lambda c, loop: make_scheduler(params, c, loop),
            reqs, [("gather-host-read", gath, "host")]))
    finally:
        moe.route, engine.prefill_chunk = route, chunk
    same_streams("moe-parity", runs, "cuda-graph", "gather-host-read",
                 "graph segments with the kernels and host-read segments "
                 "with the gather path")
    counts = device_loop.read_host(
        *(torch.stack(v).sum() for v in (*dropped.values(),
                                          *entries.values())))
    counts = dict(zip(("decode", "prefill"), (
        f"{int(d)} of {int(n)}" for d, n in zip(counts[:2], counts[2:]))))
    calls = {k: len(v) for k, v in dropped.items()}
    log(f"[moe-parity] routed entries dropped for capacity in the "
        f"host-read run (read once after it): {counts} in {calls} MoE "
        f"calls (decode: one group of 8 tokens, capacity "
        f"{moe._group_capacity(8, cfg)}; prefill: a group a row of 128 "
        f"tokens, capacity {moe._group_capacity(128, cfg)})")

    toks = torch.from_numpy(reqs[0][0]).long().cuda()
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    with torch.no_grad():
        fa_kernel.flash_attention.launches = 0
        lk, aux_k = model_zoo.forward(params, kern, batch)
        n_fa = fa_kernel.flash_attention.launches
        lg, aux_g = model_zoo.forward(params, gath, batch)
        loss_k, m_k = model_zoo.loss_fn(params, kern, batch)
        loss_g, m_g = model_zoo.loss_fn(params, gath, batch)
    err = float((lk - lg).abs().max())
    rel = {k: abs(float(m_k[k]) - float(m_g[k])) / abs(float(m_g[k]))
           for k in m_g}
    terms = {k: float(v) for k, v in m_k.items()}
    log(f"[moe-parity] model_zoo.forward fp32 B=1 S=512: flash_attention "
        f"launches {n_fa} (one a layer), max |flash - chunked| logits "
        f"{err:.3e} (tol {LOGIT_TOL:g}); loss terms {terms}, relative "
        f"differences {rel}")
    if n_fa != cfg.n_layers or err > LOGIT_TOL or \
            max(rel.values()) > MOE_LOSS_RTOL:
        raise AssertionError("moe-parity: the full forward through the "
                             "flash kernel disagrees with chunked attention")
    del params


def vlm_requests(cfg, n=16, prompt_len=256, seed=3):
    """n VLM requests: ``VLM_IMAGES`` seeded random images of
    ``n_patches`` patch embeddings (request i shows image i % 4), then
    one ``VLM_SYSTEM``-token system text and distinct tokens to
    ``prompt_len``; ``max_new`` alternating 32 and 64. Returns
    [(prompt (1, prompt_len), max_new, patches (1, n_patches, D))]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    images = [(0.02 * rng.standard_normal(
        (1, cfg.n_patches, cfg.d_model))).astype(np.float32)
        for _ in range(VLM_IMAGES)]
    system = rng.integers(2, cfg.vocab, VLM_SYSTEM)
    return [(np.concatenate([system, rng.integers(
        2, cfg.vocab, prompt_len - VLM_SYSTEM)])[None].astype(np.int32),
        32 if i % 2 == 0 else 64, images[i % VLM_IMAGES])
        for i in range(n)]


def vlm_drive(sched, reqs):
    for rid, (prompt, max_new, pe) in enumerate(reqs):
        sched.submit(prompt, max_new=max_new, request_id=rid,
                     prefix_embeds=pe)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}


def make_vlm_scheduler(params, cfg, loop=None, **kw):
    return make_scheduler(params, cfg, loop, prompt_len=256,
                          prefix_len=cfg.n_patches, **kw)


def phase_vlm():
    """internvl2-1b at full width (bf16, random weights from a seed,
    ``attn_impl="cuda"``) through the chunked paged scheduler with its
    patch prefix (``prefix_len`` 256): 16 requests of 256 seeded random
    patch embeddings and a 256-token prompt, 4 images each shown to 4
    requests behind one 64-token system text, with the prefix cache on
    and off, in graph segments. Gates: every request finishes, both
    block-table kernels launch and nothing gathers, one host read a
    segment, the cache hits, and after the drain only the index's pins
    hold blocks; two requests with one prompt and two images never hit.
    Prints hit blocks, chunk iterations and tok/s, on against off. Then
    at 4 layers in fp32: the kernel path with the prefix cache in graph
    segments gives the gather path's streams without it, 16/16."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("internvl2-1b"), attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device="cuda")
    reqs = vlm_requests(cfg)
    counters = launch_counters()
    runs = {}
    for pfx in (False, True):
        tag = f"vlm prefix-cache {'on' if pfx else 'off'}"
        sched = make_vlm_scheduler(params, cfg, prefix_cache=pfx)
        sched.warmup()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        streams = vlm_drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: getattr(o, a) for n, (o, a) in counters.items()}
        check_streams(streams, [(p, m) for p, m, _ in reqs], cfg)
        check_kernel_path(tag, launches)
        if sched.host_reads != sched.segments:
            raise AssertionError(f"{tag}: {sched.host_reads} host reads "
                                 f"for {sched.segments} segments")
        pinned = check_drained(tag, sched)
        runs[pfx] = run = {"tok_s": sched.tokens_emitted / wall,
                           "chunk_iters": int(sched._counts[2]),
                           "hits": sched.prefix_hit_blocks,
                           "launches": launches}
        log(f"[{tag}] {sched.loop_impl} ({sched.attn_impl} / "
            f"{sched.prefill_impl}), prefix_len {sched.prefix_len}: "
            f"{sched.tokens_emitted} tokens in {wall:.3f} s -> "
            f"{run['tok_s']:.1f} tok/s; {sched.total_steps} iterations "
            f"({run['chunk_iters']} ran a chunk); hit blocks {run['hits']}, "
            f"evictions {sched.prefix_evictions}, pinned after the drain "
            f"{pinned}; {sched.host_reads} host reads for {sched.segments} "
            f"segments; launches { {n: v for n, v in launches.items() if v} }"
            f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")
        sched.close()
    on, off = runs[True], runs[False]
    log(f"[vlm] prefix cache on vs off: hit blocks {on['hits']} vs "
        f"{off['hits']}, chunk iterations {on['chunk_iters']} vs "
        f"{off['chunk_iters']}, tok/s {on['tok_s']:.1f} vs "
        f"{off['tok_s']:.1f}")
    if on["hits"] == 0:
        raise AssertionError("vlm: requests sharing an image never hit")
    distinct = [(reqs[0][0], 4, reqs[0][2]), (reqs[0][0], 4, reqs[1][2])]
    sched = make_vlm_scheduler(params, cfg, prefix_cache=True, n_slots=1)
    vlm_drive(sched, distinct)
    log(f"[vlm] one prompt, two images, one slot: hit blocks "
        f"{sched.prefix_hit_blocks}")
    if sched.prefix_hit_blocks:
        raise AssertionError("vlm: distinct images hit")
    sched.close()
    del params
    free_device_memory("the fp32 VLM parity runs")

    fcfg = dataclasses.replace(get_config("internvl2-1b"),
                               compute_dtype="float32",
                               n_layers=MOE_PARITY_LAYERS)
    fparams = bridge.init_params(fcfg, seed=0, device="cuda")
    par = {}
    for name, c, pfx in (
            ("cuda-graph-cache", dataclasses.replace(fcfg, attn_impl="cuda"),
             True),
            ("gather-graph", dataclasses.replace(fcfg, attn_impl="gather"),
             False)):
        sched = make_vlm_scheduler(fparams, c, prefix_cache=pfx)
        t0 = time.perf_counter()
        par[name] = vlm_drive(sched, reqs)
        torch.cuda.synchronize()
        log(f"[vlm-parity] fp32 {name} ({sched.loop_impl}): "
            f"{sched.tokens_emitted} tokens in "
            f"{time.perf_counter() - t0:.2f} s, hit blocks "
            f"{sched.prefix_hit_blocks}")
        sched.close()
    same_streams("vlm-parity", par, "cuda-graph-cache", "gather-graph",
                 "the kernel path with the prefix cache and the gather path")
    del fparams
    return {k: on["launches"][k] for k in ("paged_attention",
                                            "flash_prefill")}


# ------------------------------------------- phases 30-32: this slice's paths

def launch_and_resume(tag, cfg, what, argv, ckpt):
    """``launch.train.main`` at full width (fp32 masters, bf16 compute)
    with ``argv`` and a checkpoint at step ``ckpt`` into a temporary
    directory: the loss is finite and falls (the mean of the last quarter
    of the steps below the first quarter's), and a second launch resumes
    from the checkpoint and reruns the steps after it with the first
    launch's losses (the first bit for bit, the rest within
    ``RESUME_RTOL``); the forward-only flash kernel never launches.
    Prints ms a step and peak memory; returns (median ms a step, peak
    GiB)."""
    import gc
    import math
    import shutil
    import statistics
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo

    n_params = model_zoo.count_params(cfg)
    root = checkpoint_root(3 * 4 * n_params)
    argv = ["--arch", cfg.name, *argv, "--ckpt-dir", root, "--ckpt-every",
            str(ckpt)]
    try:
        fa_kernel.flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = launch_train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = first["trainer"].history
        losses = [h[1] for h in hist]
        step_ms = [h[2] * 1e3 for h in hist]
        k = len(losses) // 4
        a, b = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
        median = statistics.median(step_ms[1:])
        log(f"[{tag}] {card_label()}: {cfg.name} "
            f"({n_params / 1e9:.3f}B params) fp32 masters, bf16 compute, "
            f"{what}: {len(losses)} steps in {wall:.1f} s; ms a step median "
            f"{median:.1f} (first {step_ms[0]:.1f}); peak memory "
            f"{peak / 2**30:.2f} GiB; losses "
            + " ".join(f"{x:.4f}" for x in losses)
            + f"; mean of the first {k} {a:.5f}, of the last {k} {b:.5f}")
        if not all(math.isfinite(x) for x in losses) or not b < a:
            raise AssertionError(f"{tag}: the loss is not finite or does "
                                 f"not fall")
        del first
        gc.collect()
        torch.cuda.empty_cache()
        again = launch_train.main(argv)
        rerun = [(h[0], h[1]) for h in again["trainer"].history]
        want = [(h[0], h[1]) for h in hist[ckpt:]]
        rel = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(rerun, want))
        log(f"[{tag}] second launch resumed at step {again['start']}: "
            f"losses {[x for _, x in rerun]} against the first launch's "
            f"{[x for _, x in want]}; max relative difference {rel:.3e}")
        # the restored state is the saved one, so the first resumed
        # step's forward, and its loss, are the first launch's bit for
        # bit; later steps follow updates whose backward adds the
        # embedding's row gradients atomically, in any order
        if again["start"] != ckpt or \
                [s for s, _ in rerun] != [s for s, _ in want] or \
                rerun[0] != want[0] or rel > RESUME_RTOL:
            raise AssertionError(f"{tag}: the resume does not continue "
                                 f"exactly")
        del again
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if fa_kernel.flash_attention.launches:
        raise AssertionError(f"{tag} launched the forward-only kernel")
    gc.collect()
    torch.cuda.empty_cache()
    return median, peak / 2**30


def phase_train_families():
    """Training the MoE and VLM families on the card. internvl2-1b at
    full width through ``launch_and_resume`` (lr ``TRAIN_FAMILY_LR``,
    B=4, S=1024 tokens behind 256 patch embeddings,
    ``TRAIN_FAMILY_STEPS`` steps, a checkpoint at step
    ``TRAIN_FAMILY_CKPT``): the loss is finite and falls, and a second
    launch resumes from the checkpoint and reruns the steps after it
    with the first launch's losses (the first bit for bit, the rest
    within ``RESUME_RTOL``). qwen2-moe-a2.7b at full
    width and ``MOE_TRAIN_LAYERS`` layers through
    ``train_loop.make_train_step`` (B=2, S=512, ``MOE_TRAIN_STEPS``
    steps, no checkpoint): the loss is finite and falls, both aux terms
    are finite, and every layer's router gets a non-zero gradient. Both
    print ms a step and peak memory; neither launches the forward-only
    flash kernel."""
    import dataclasses
    import math
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    cfg = get_config("internvl2-1b")
    launch_and_resume(
        "train-vlm", cfg, f"B=4, S=1024 + {cfg.n_patches} patches",
        ["--batch", "4", "--seq", "1024", "--steps",
         str(TRAIN_FAMILY_STEPS), "--lr", str(TRAIN_FAMILY_LR)],
        TRAIN_FAMILY_CKPT)

    mcfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                               n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = bridge.init_params(mcfg, seed=0, device="cuda",
                                keep_param_dtype=True)
    opt = adamw.init(params)
    data = SyntheticLM(mcfg.vocab, 512, 2, seed=0)
    step_fn = train_loop.make_train_step(mcfg, adamw.AdamWConfig(lr=1e-3))
    rows = []
    for i in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, data.batch_at(i))
        terms = {k: float(m[k]) for k in ("loss", "ce", "moe_load_balance",
                                          "moe_z_loss")}
        rows.append((terms, (time.perf_counter() - t0) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    losses = [r[0]["loss"] for r in rows]
    log(f"[train-moe] {mcfg.name} at full width, {MOE_TRAIN_LAYERS} layers "
        f"({model_zoo.count_params(mcfg) / 1e9:.3f}B params), fp32 masters,"
        f" bf16 compute, B=2, S=512: ms a step "
        f"{', '.join(f'{r[1]:.1f}' for r in rows)}; peak memory "
        f"{peak / 2**30:.2f} GiB; per step (loss, ce, load balance, "
        f"z loss): " + "; ".join(
            ", ".join(f"{v:.5f}" for v in r[0].values()) for r in rows))
    if not all(math.isfinite(v) for r in rows for v in r[0].values()) or \
            not losses[-1] < losses[0]:
        raise AssertionError("train-moe: a loss term is not finite or the "
                             "loss does not fall")
    leaves, spec = pytree.tree_flatten(params)
    router = params["layers"]["moe"]["router"]
    live = [t if t is router else t.detach() for t in leaves]
    router.requires_grad_(True)
    batch = train_loop.batch_to_device(data.batch_at(MOE_TRAIN_STEPS),
                                       "cuda")
    with torch.enable_grad():
        loss, _ = model_zoo.loss_fn(bridge.compute_params(
            pytree.tree_unflatten(live, spec), mcfg), mcfg, batch)
        (g,) = torch.autograd.grad(loss, [router])
    per_layer = g.abs().amax(dim=(1, 2)).tolist()
    log(f"[train-moe] router gradient max |g| by layer: "
        f"{[f'{x:.3e}' for x in per_layer]}")
    if not all(x > 0 for x in per_layer):
        raise AssertionError("train-moe: a router gets no gradient")
    if fa_kernel.flash_attention.launches:
        raise AssertionError("train-moe launched the forward-only kernel")
    del params, opt, leaves, live, router, g


def family_serving(arch):
    """(requests, scheduler factory, driver) of a family's serving pool:
    the MoE's 16 x 512 exact-length prompts through ``make_scheduler``,
    the VLM's 16 patch-prefixed requests through ``make_vlm_scheduler``
    (without the prefix cache)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.family == "vlm":
        return (vlm_requests(cfg),
                lambda p, c, loop=None: make_vlm_scheduler(p, c, loop),
                vlm_drive)
    return (moe_requests(cfg),
            lambda p, c, loop=None: make_scheduler(p, c, loop), drive)


def adaptive_family(arch):
    """Phase 31 for one family at full width (bf16, ``attn_impl="cuda"``,
    graph segments): threshold inf against the non-adaptive run in turns
    (plain, inf, inf, plain): streams bit for bit, mean depth exactly
    n_layers, launches equal but for the decode steps whose emitting
    rows all retire (no layer runs); exit by construction (identity tail
    from layer ``EXIT_AT``, threshold -1, floor ``EXIT_AT``) against the
    doctored model's non-adaptive run: streams equal, mean depth exactly
    ``EXIT_AT``, ``paged_attention`` launches exactly ``EXIT_AT``/L of
    its over the decode steps with a live row, ``flash_prefill``
    unchanged; mixture-of-depths (capacity 0.5,
    every 2, zero routers) runs to the end. ``adaptive_run`` gates one
    host read a segment. Then at ``MOE_PARITY_LAYERS`` layers in fp32,
    with early exit at inf and mixture-of-depths on: the kernel path in
    graph and host-read segments and the gather path give one set of
    streams. Returns the first inf run's launches."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config

    tag = f"adaptive {arch}"
    reqs, make, driver = family_serving(arch)
    cfg = dataclasses.replace(get_config(arch), attn_impl="cuda")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_layers=MOE_SERVE_LAYERS)
    L = cfg.n_layers
    params = bridge.init_params(cfg, seed=0, device="cuda")
    inf = dataclasses.replace(cfg, early_exit=True)
    # decode steps whose emitting rows all retire run no layer
    # (``idle_layer_loops``): L fewer paged_attention launches each
    idle = torch.zeros((), dtype=torch.int64, device="cuda")
    plain = ready(make(params, cfg), reqs, driver)
    with idle_layer_loops(idle):
        ada = ready(make(params, inf), reqs, driver)
    a1 = adaptive_run(f"{tag} plain", plain, reqs, driver)
    b1 = counted_run(f"{tag} inf", ada, reqs, idle, driver)
    b2 = counted_run(f"{tag} inf", ada, reqs, idle, driver)
    a2 = adaptive_run(f"{tag} plain", plain, reqs, driver)
    plain.close()
    ada.close()
    want = {k: a1["launches"][k] for k in ("paged_attention",
                                           "flash_prefill")}
    for run in (b1, b2):
        same_count(f"{tag} inf", run["streams"], a1["streams"])
        got = {k: run["launches"][k] for k in want}
        less = {"paged_attention": want["paged_attention"]
                - L * run["idle"], "flash_prefill": want["flash_prefill"]}
        if run["mean_depth"] != float(L) or got != less or \
                run["depth_impl"] != "cuda-graph:if-per-layer":
            raise AssertionError(
                f"{tag} inf: mean depth {run['mean_depth']}, launches "
                f"{got} against {less} ({run['idle']} decode steps with "
                f"every emitting row retiring), lowering "
                f"{run['depth_impl']}")

    doc = identity_tail(params, EXIT_AT)
    ecfg = dataclasses.replace(cfg, early_exit=True, exit_threshold=-1.0,
                               exit_min_layers=EXIT_AT)
    dplain = ready(make(doc, cfg), reqs, driver)
    with idle_layer_loops(idle):
        dexit = ready(make(doc, ecfg), reqs, driver)
    c1 = adaptive_run(f"{tag} exit plain", dplain, reqs, driver)
    d1 = counted_run(f"{tag} exit", dexit, reqs, idle, driver)
    dplain.close()
    dexit.close()
    same_count(f"{tag} exit", d1["streams"], c1["streams"])
    pa, fp = (d1["launches"][k] for k in ("paged_attention",
                                          "flash_prefill"))
    if d1["mean_depth"] != float(EXIT_AT) or \
            pa * L != (c1["launches"]["paged_attention"]
                       - L * d1["idle"]) * EXIT_AT or \
            fp != c1["launches"]["flash_prefill"]:
        raise AssertionError(f"{tag} exit: mean depth {d1['mean_depth']}, "
                             f"launches pa {pa} fp {fp} against "
                             f"{c1['launches']} ({d1['idle']} decode steps "
                             f"with every emitting row retiring)")
    log(f"[{tag}] exit at {EXIT_AT}: paged_attention {pa} = {EXIT_AT}/{L} "
        f"of {c1['launches']['paged_attention']} less {L} x {d1['idle']} "
        f"(device-counted), flash_prefill {fp} unchanged")
    del doc

    mod = dataclasses.replace(cfg, mod_capacity=0.5, mod_every=2)
    mparams = {**params, "layers": {**params["layers"], "router": {
        "w": torch.zeros((L, cfg.d_model), device="cuda")}}}
    msched = ready(make(mparams, mod), reqs, driver)
    m = adaptive_run(f"{tag} mod", msched, reqs, driver)
    msched.close()
    if m["mean_depth"] != float(L):
        raise AssertionError(f"{tag} mod: zero routers skipped blocks "
                             f"(mean depth {m['mean_depth']})")
    log(f"[{tag}] {card_label()}: tok/s non-adaptive {a1['tok_s']:.1f}, "
        f"{a2['tok_s']:.1f}; inf {b1['tok_s']:.1f}, {b2['tok_s']:.1f} "
        f"(x{b1['tok_s'] / a1['tok_s']:.3f}); doctored non-adaptive "
        f"{c1['tok_s']:.1f}, exit at {EXIT_AT} {d1['tok_s']:.1f} "
        f"(x{d1['tok_s'] / c1['tok_s']:.3f}); mixture-of-depths "
        f"{m['tok_s']:.1f} | device ms an iteration: non-adaptive "
        f"{a1['ms_iter']:.4f}, {a2['ms_iter']:.4f}; inf "
        f"{b1['ms_iter']:.4f}, {b2['ms_iter']:.4f}; doctored "
        f"{c1['ms_iter']:.4f}; exit {d1['ms_iter']:.4f}; mod "
        f"{m['ms_iter']:.4f}")
    del params, mparams
    free_device_memory(f"the {arch} adaptive parity runs")

    fcfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                               n_layers=MOE_PARITY_LAYERS, early_exit=True,
                               mod_capacity=0.5, mod_every=2)
    fparams = bridge.init_params(fcfg, seed=0, device="cuda")
    sub = reqs[:8]
    kern = dataclasses.replace(fcfg, attn_impl="cuda")
    gath = dataclasses.replace(fcfg, attn_impl="gather")
    par = {}
    for name, c, loop in (("cuda-graph", kern, None),
                          ("cuda-host-read", kern, "host"),
                          ("gather-host-read", gath, "host")):
        sched = make(fparams, c, loop)
        t0 = time.perf_counter()
        par[name] = driver(sched, sub)
        torch.cuda.synchronize()
        log(f"[{tag} parity] fp32 {MOE_PARITY_LAYERS} layers, early exit "
            f"inf and mixture-of-depths, {name} ({sched.loop_impl}, layer "
            f"loop {sched.depth_impl}): {sched.tokens_emitted} tokens in "
            f"{time.perf_counter() - t0:.2f} s, mean depth "
            f"{sched.mean_depth:.4f}")
        sched.close()
    same_streams(f"{tag} parity", par, "cuda-graph", "cuda-host-read",
                 "graph and host-read segments under adaptive depth")
    same_streams(f"{tag} parity", par, "cuda-graph", "gather-host-read",
                 "the kernel and gather paths under adaptive depth")
    del fparams
    return b1["launches"]


def phase_adaptive_families():
    """Adaptive depth on the MoE and VLM families (``adaptive_family``
    for qwen2-moe-a2.7b, then internvl2-1b). Returns each family's first
    inf run's launches."""
    out = {}
    for arch in ("qwen2-moe-a2.7b", "internvl2-1b"):
        out[f"{arch} early-exit"] = adaptive_family(arch)
        free_device_memory("the next family")
    return out


def make_hybrid_scheduler(params, cfg, loop=None):
    """The hybrid's pool: one-shot admission (the only mode it takes),
    8 slots, 512-token prompts, 64 new at most, the paged cache in
    blocks of 16 (the shared block's K/V, one cache layer an
    application)."""
    from repro_torch.serve import scheduler as sched_lib
    return sched_lib.DecodeScheduler(
        params, cfg, n_slots=8, prompt_len=512, max_new_cap=64, eos_id=-1,
        kv="paged", kv_block=16, prefill="oneshot", loop=loop)


def hybrid_decode_bytes(cfg, slots, positions):
    """Bytes a decode iteration must move at ``slots`` rows with
    ``positions`` cached positions in all: every mamba2 layer's weights,
    the shared block's once an application (the 50 MB L2 cannot keep
    its 134 MB between applications), the unembedding, in bf16; the
    fp32 SSM state (and the conv state) read and written; each
    application's K/V of the cached positions. Returns (total, parts)."""
    from repro_torch.serve import engine
    D, s = cfg.d_model, cfg.ssm
    di, H = cfg.d_inner, cfg.d_inner // s.head_dim
    n_apps = engine._attn_layer_count(cfg)
    mamba = cfg.n_layers * (D * (2 * di + 2 * s.d_state + H)
                            + di * D + s.d_conv * (di + 2 * s.d_state)) * 2
    shared = (4 * D * cfg.n_heads * cfg.resolved_head_dim
              + 3 * D * cfg.d_ff) * 2
    unembed = D * cfg.padded_vocab * 2
    state = cfg.n_layers * slots * (H * s.head_dim * s.d_state * 4
                                    + (s.d_conv - 1) * (di + 2 * s.d_state)
                                    * 2) * 2
    kv = positions * n_apps * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    parts = {"mamba2": mamba, "shared x apps": shared * n_apps,
             "unembed": unembed, "ssm state r+w": state, "kv": kv}
    return sum(parts.values()), parts


def hybrid_admission_ms(params, cfg, reqs):
    """One one-shot prefill of ``reqs`` (8 x 512 tokens, what an
    admission runs) into a paged cache, under the profiler: the device
    ms of its kernels, and the wall ms of the call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import engine
    tokens = torch.from_numpy(np.concatenate([p for p, _ in reqs])).to(
        "cuda", torch.long)
    B, S = tokens.shape
    cache = engine.make_cache(cfg, B, S + 1, kv_impl="paged", kv_block=16,
                              device="cuda")
    cache["attn"].alloc(torch.arange(B, device="cuda"),
                        torch.full((B,), S + 1, device="cuda"))
    engine.prefill(params, cfg, tokens, cache)       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.prefill(params, cfg, tokens, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sum(r.self_device_time_total for r in profile_rows(prof)
              if r.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dev, wall


def phase_hybrid():
    """zamba2-1.2b at full width (38 mamba2 layers under one shared
    attention block applied 7 times; bf16, random weights from a seed,
    ``attn_impl="cuda"``) through one-shot admission: 16 requests of
    exactly 512 tokens, 64 new each, EOS -1, graph and host-read
    segments in turns (``serve_in_turns``). Gates: every request
    finishes, one host read a graph segment, ``paged_attention`` launches
    equal across lowerings at 7 a decode iteration, no gather. Prints
    tok/s, a decode-only segment's device ms an iteration beside its
    bytes bound, and an admission's device ms. Then at
    ``HYBRID_PARITY_LAYERS`` layers (2 applications) in fp32: the kernel
    path in graph and host-read segments and the gather path give one
    set of streams. Returns the launches of the first graph run."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serve import engine

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), attn_impl="cuda")
    n_apps = engine._attn_layer_count(cfg)
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(params))
    log(f"[hybrid] {cfg.name}: {cfg.n_layers} mamba2 layers (d_inner "
        f"{cfg.d_inner}, {cfg.d_inner // cfg.ssm.head_dim} heads of "
        f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}), one shared block "
        f"({cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim},"
        f" d_ff {cfg.d_ff}) applied {n_apps} times; weights "
        f"{nbytes / 1e9:.2f} GB drawn in {time.perf_counter() - t0:.1f} s")
    reqs = moe_requests(cfg)
    launches, runs = serve_in_turns(
        "hybrid", cfg, lambda loop: make_hybrid_scheduler(params, cfg, loop),
        reqs, admissions=True, profile=False)
    for run in runs:
        pa = run["launches"]["paged_attention"]
        if pa != n_apps * run["decodes"] or run["launches"]["gather"]:
            raise AssertionError(
                f"hybrid {run['loop']}: paged_attention {pa} for "
                f"{run['decodes']} decode iterations of {n_apps} "
                f"applications; gather {run['launches']['gather']}")
    g = runs[0]
    adm = [a * 1e3 for r in runs for a in r["admissions"]]
    log(f"[hybrid] {cfg.name} bf16, {g['attn_impl']} / {g['prefill_impl']},"
        f" one-shot, 8 slots: graph {runs[0]['tok_s']:.1f}, "
        f"{runs[3]['tok_s']:.1f} tok/s; host-read {runs[1]['tok_s']:.1f}, "
        f"{runs[2]['tok_s']:.1f}; paged_attention "
        f"{g['launches']['paged_attention']}"
        f" launches = {n_apps} x {g['decodes']} decode iterations; "
        f"admissions (wall, synchronised) "
        f"{min(adm):.1f}-{max(adm):.1f} ms")
    sched = make_hybrid_scheduler(params, cfg)
    sched.warmup()
    ms = decode_only_ms(sched, reqs[:8], prefill_iters=4)
    sched.close()
    total, parts = hybrid_decode_bytes(cfg, 8, 8 * (512 + 20))
    bound = total / HBM_BYTES_PER_S * 1e3
    adm_dev, adm_wall = hybrid_admission_ms(params, cfg, reqs[:8])
    log(f"[hybrid] {card_label()}: decode-only iteration at 8 running "
        f"slots {ms:.3f} device ms (graph segment, CUDA events); bytes "
        f"bound {bound:.3f} ms ({total / 1e9:.3f} GB: "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
        + f" GB; predicted 1.1 ms); ms/bound {ms / bound:.2f}; an "
        f"admission of 8 x 512 tokens: device {adm_dev:.2f} ms (profiled "
        f"kernels), wall {adm_wall:.2f} ms")
    del params
    free_device_memory("the fp32 hybrid parity runs")

    fcfg = dataclasses.replace(get_config("zamba2-1.2b"),
                               compute_dtype="float32",
                               n_layers=HYBRID_PARITY_LAYERS)
    fparams = bridge.init_params(fcfg, seed=0, device="cuda")
    runs = parity_runs(
        "hybrid-parity", lambda c, loop: make_hybrid_scheduler(fparams, c,
                                                               loop),
        reqs[:8], [("cuda-graph", dataclasses.replace(fcfg, attn_impl="cuda"),
                    None),
                   ("cuda-host-read", dataclasses.replace(
                       fcfg, attn_impl="cuda"), "host"),
                   ("gather-graph", dataclasses.replace(
                       fcfg, attn_impl="gather"), None)])
    same_streams("hybrid-parity", runs, "cuda-graph", "cuda-host-read",
                 "graph and host-read segments")
    same_streams("hybrid-parity", runs, "cuda-graph", "gather-graph",
                 "the paged kernel and the gather path")
    del fparams
    return {k: launches[k] for k in ("paged_attention", "flash_prefill")}


def whisper_requests(cfg, n=16, seed=5):
    """n audio requests (numpy seed ``seed``): a prompt of 4 to
    ``WHISPER_PROMPT`` random tokens, ``WHISPER_NEW`` new tokens, and
    ``n_frames`` standard-normal frame embeddings (the stub frontend's
    output, as ``SyntheticLM`` draws them). Returns [(prompt (1, L),
    max_new, frames (1, n_frames, d_model))]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_tok = int(rng.integers(4, WHISPER_PROMPT + 1))
        out.append((rng.integers(2, cfg.vocab, (1, n_tok)).astype(np.int32),
                    WHISPER_NEW, rng.standard_normal(
                        (1, cfg.n_frames, cfg.d_model)).astype(np.float32)))
    return out


def make_whisper_scheduler(params, cfg, loop=None):
    """The audio family's pool: one-shot admission (the only mode it
    takes), 8 slots, prompts of up to ``WHISPER_PROMPT`` tokens bucketed
    to powers of two, ``WHISPER_NEW`` new at most, the paged self cache
    in blocks of 16 (the cross K/V dense, one row a slot)."""
    from repro_torch.serve import scheduler as sched_lib
    return sched_lib.DecodeScheduler(
        params, cfg, n_slots=8, prompt_len=WHISPER_PROMPT,
        max_new_cap=WHISPER_NEW, eos_id=-1, kv="paged", kv_block=16,
        prefill="oneshot", loop=loop)


def encdec_decode_bytes(cfg, slots, positions):
    """Bytes a decode iteration of the encoder-decoder must move at
    ``slots`` rows with ``positions`` cached self-attention positions in
    all, in bf16: every decoder layer's weights that a decode reads (the
    self-attention's four projections, the cross-attention's query and
    output ones: its K/V are cached, the MLP with its biases, the norms),
    the tied unembedding, every slot's cross K/V (``n_frames`` positions
    a layer) and the self K/V of the cached positions. Returns (total,
    parts)."""
    D, L, F = cfg.d_model, cfg.n_layers, cfg.n_frames
    hh = cfg.n_heads * cfg.resolved_head_dim
    kvw = cfg.n_kv_heads * cfg.resolved_head_dim
    layer = (4 * D * hh + 2 * D * hh + 2 * D * cfg.d_ff + cfg.d_ff + D
             + 6 * D)
    parts = {"decoder weights": L * layer * 2,
             "unembed": cfg.padded_vocab * D * 2,
             "cross k/v": slots * L * F * 2 * kvw * 2,
             "self k/v": positions * L * 2 * kvw * 2}
    return sum(parts.values()), parts


def whisper_admission_ms(params, cfg, reqs):
    """One one-shot prefill of ``reqs`` (8 requests, right-padded to
    their bucket, with their frames: what an admission runs) into a
    paged cache, under the profiler: the device ms of its kernels, the
    share of them in the encoder's call (its own profiled run), and the
    wall ms of the call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import encdec
    from repro_torch.serve import engine
    longest = max(p.shape[1] for p, _, _ in reqs)
    width = min(1 << (longest - 1).bit_length(), WHISPER_PROMPT)
    toks = np.zeros((len(reqs), width), np.int32)
    for i, (p, _, _) in enumerate(reqs):
        toks[i, :p.shape[1]] = p[0]
    tokens = torch.from_numpy(toks).to("cuda", torch.long)
    frames = torch.from_numpy(np.concatenate([f for _, _, f in reqs])).to(
        "cuda")
    B = len(reqs)
    cache = engine.make_cache(cfg, B, width + 1, kv_impl="paged",
                              kv_block=16, device="cuda")
    cache["self"].alloc(torch.arange(B, device="cuda"),
                        torch.full((B,), width + 1, device="cuda"))

    def device_ms(fn):
        fn()                                        # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = sum(r.self_device_time_total for r in profile_rows(prof)
                  if r.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        return dev, wall

    dev, wall = device_ms(lambda: engine.prefill(params, cfg, tokens, cache,
                                                 frames=frames))
    enc, _ = device_ms(lambda: encdec.encode(params, cfg, frames))
    return dev, enc, wall, width


def phase_whisper_serve():
    """whisper-small at full width (12 encoder and 12 decoder layers,
    d_model 768, 12 heads of 64, vocab 51865, 1500 stub frames; bf16,
    random weights and frames from a seed, ``attn_impl="cuda"``) through
    one-shot admission: 16 requests of 4-192 tokens, 128 new each, EOS
    -1, graph and host-read segments in turns (``serve_in_turns``).
    Gates: every request finishes, one host read a graph segment,
    ``paged_attention`` launches equal across lowerings at 12 a decode
    iteration, no gather on the self cache. Prints tok/s each way and
    the device-busy share, an admission's device ms (and the encoder's
    part), and a decode-only segment's device ms an iteration beside its
    bytes bound (``encdec_decode_bytes``). Returns the launches of the
    first graph run."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("whisper-small"), attn_impl="cuda")
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(params))
    log(f"[whisper] {cfg.name}: {cfg.encoder_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim},"
        f" d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_frames} frames; "
        f"weights {nbytes / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = whisper_requests(cfg)
    launches, runs = serve_in_turns(
        "whisper", cfg, lambda loop: make_whisper_scheduler(params, cfg,
                                                            loop),
        reqs, admissions=True, profile=False)
    for run in runs:
        pa = run["launches"]["paged_attention"]
        if pa != cfg.n_layers * run["decodes"] or run["launches"]["gather"]:
            raise AssertionError(
                f"whisper {run['loop']}: paged_attention {pa} for "
                f"{run['decodes']} decode iterations of {cfg.n_layers} "
                f"layers; gather {run['launches']['gather']}")
    g = runs[0]
    busy = [r["seg_ms"] / 1e3 / r["wall"] for r in runs if "seg_ms" in r]
    adm = [a * 1e3 for r in runs for a in r["admissions"]]
    log(f"[whisper] {card_label()}: {cfg.name} bf16, {g['attn_impl']} / "
        f"{g['prefill_impl']}, one-shot, 8 slots: graph "
        f"{runs[0]['tok_s']:.1f}, {runs[3]['tok_s']:.1f} tok/s (device busy "
        f"in segments {', '.join(f'{b:.3f}' for b in busy)} of the wall); "
        f"host-read {runs[1]['tok_s']:.1f}, {runs[2]['tok_s']:.1f}; "
        f"paged_attention {g['launches']['paged_attention']} launches = "
        f"{cfg.n_layers} x {g['decodes']} decode iterations; admissions "
        f"(wall, synchronised) {min(adm):.1f}-{max(adm):.1f} ms")
    sched = make_whisper_scheduler(params, cfg)
    sched.warmup()
    ms = decode_only_ms(sched, reqs[:8], prefill_iters=4)
    sched.close()
    # the timed segment's middle: 4 + 16 tokens past each prompt
    positions = sum(p.shape[1] + 20 for p, _, _ in reqs[:8])
    total, parts = encdec_decode_bytes(cfg, 8, positions)
    bound_ms = total / HBM_BYTES_PER_S * 1e3
    adm_dev, enc_dev, adm_wall, width = whisper_admission_ms(params, cfg,
                                                            reqs[:8])
    log(f"[whisper] {card_label()}: decode-only iteration at 8 running "
        f"slots {ms:.3f} device ms (graph segment, CUDA events); bytes "
        f"bound {bound_ms:.3f} ms ({total / 1e9:.3f} GB: "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
        + f" GB; predicted 3-5 ms); ms/bound {ms / bound_ms:.2f}; an "
        f"admission of 8 requests (bucket {width}, {cfg.n_frames} frames "
        f"each): device {adm_dev:.2f} ms (profiled kernels), of which the "
        f"encoder's call {enc_dev:.2f} ms; wall {adm_wall:.2f} ms")
    del params
    return {k: launches[k] for k in ("paged_attention", "flash_prefill")}


def phase_whisper_parity():
    """whisper-small at full width and ``WHISPER_PARITY_LAYERS`` encoder
    and decoder layers in fp32: 8 of the serving requests through the
    kernel path in graph and host-read segments and the gather path give
    one set of greedy streams; then ``engine.prefill_chunk`` over a
    paged cache, through the flash-prefill kernel in chunks of
    ``WHISPER_CHUNK`` against the cross K/V a one-shot prefill returned,
    gives the one-shot prefill's logits within LOGIT_TOL at every
    position of 4 rows of ``WHISPER_PROMPT`` tokens, one kernel launch a
    layer a chunk."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import kernel as fp_kernel
    from repro_torch.serve import engine

    fcfg = dataclasses.replace(get_config("whisper-small"),
                               compute_dtype="float32",
                               n_layers=WHISPER_PARITY_LAYERS,
                               encoder_layers=WHISPER_PARITY_LAYERS)
    fparams = bridge.init_params(fcfg, seed=0, device="cuda")
    reqs = whisper_requests(fcfg)[:8]
    kern = dataclasses.replace(fcfg, attn_impl="cuda")
    runs = parity_runs(
        "whisper-parity",
        lambda c, loop: make_whisper_scheduler(fparams, c, loop), reqs,
        [("cuda-graph", kern, None), ("cuda-host-read", kern, "host"),
         ("gather-graph", dataclasses.replace(fcfg, attn_impl="gather"),
          None)])
    same_streams("whisper-parity", runs, "cuda-graph", "cuda-host-read",
                 "graph and host-read segments")
    same_streams("whisper-parity", runs, "cuda-graph", "gather-graph",
                 "the paged kernel and the gather path")

    B, S, C = 4, WHISPER_PROMPT, WHISPER_CHUNK
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(2, fcfg.vocab, (B, S))).to(
        "cuda", torch.long)
    frames = torch.from_numpy(rng.standard_normal(
        (B, fcfg.n_frames, fcfg.d_model)).astype(np.float32)).to("cuda")

    def paged():
        cache = engine.make_cache(kern, B, S + 1, kv_impl="paged",
                                  kv_block=16, device="cuda")
        cache["self"].alloc(torch.arange(B, device="cuda"),
                            torch.full((B,), S + 1, device="cuda"))
        return cache

    ref, fresh = engine.prefill(fparams, kern, tokens, paged(),
                                frames=frames)
    cache = paged()
    cache["cross"] = fresh["cross"]
    got = torch.empty_like(ref)
    fp_kernel.flash_prefill.launches = 0
    for off in range(0, S, C):
        got[:, off:off + C] = engine.prefill_chunk(
            fparams, kern, tokens, cache,
            torch.full((B,), off, dtype=torch.int32, device="cuda"),
            chunk=C, mask=torch.ones(B, dtype=torch.bool, device="cuda"))
    n_launch = fp_kernel.flash_prefill.launches
    err = (got - ref).abs().max().item()
    ok = torch.allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    log(f"[whisper-parity] prefill_chunk (flash_prefill, {B} rows, chunks "
        f"of {C}) against the one-shot prefill, fp32: max |logits diff| "
        f"{err:.3e} over {B} x {S} positions (tol {LOGIT_TOL:g}); "
        f"flash_prefill launches {n_launch}")
    if not ok or n_launch != fcfg.n_layers * (S // C):
        raise AssertionError("whisper-parity: the chunked prefill does not "
                             "give the one-shot prefill's logits through "
                             "the kernel")
    del fparams, fresh, cache


def phase_train_whisper_zamba():
    """Training the audio family and the hybrid at full width through
    ``launch.train.main`` (fp32 masters, bf16 compute). whisper-small
    (``launch_and_resume``): B=8, S=448 (its ``max_target_len``) behind
    1500 stub frames a row, lr ``WHISPER_TRAIN_LR``,
    ``WHISPER_TRAIN_STEPS`` steps, a checkpoint at
    ``WHISPER_TRAIN_CKPT``: the loss finite and falling, the resume
    exact. zamba2-1.2b (38 layers, ``remat="full"``, the shared block
    outside the remat as in the JAX package): B=``ZAMBA_TRAIN_BATCH``,
    S=2048, lr ``TRAIN_FAMILY_LR``, ``ZAMBA_TRAIN_STEPS`` steps: the loss
    finite and falling (the mean of the last 3 below the first 3's).
    Both print ms a step and peak memory."""
    import math
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo

    cfg = get_config("whisper-small")
    launch_and_resume(
        "train-whisper", cfg,
        f"B=8, S={cfg.max_target_len} behind {cfg.n_frames} frames",
        ["--batch", "8", "--seq", str(cfg.max_target_len), "--steps",
         str(WHISPER_TRAIN_STEPS), "--lr", str(WHISPER_TRAIN_LR)],
        WHISPER_TRAIN_CKPT)

    zcfg = get_config("zamba2-1.2b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = launch_train.main(
        ["--arch", zcfg.name, "--batch", str(ZAMBA_TRAIN_BATCH), "--seq",
         "2048", "--steps", str(ZAMBA_TRAIN_STEPS), "--lr",
         str(TRAIN_FAMILY_LR)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = out["trainer"].history
    losses = [h[1] for h in hist]
    step_ms = [h[2] * 1e3 for h in hist]
    a, b = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    log(f"[train-hybrid] {card_label()}: {zcfg.name} "
        f"({model_zoo.count_params(zcfg) / 1e9:.3f}B params, "
        f"{zcfg.n_layers} layers, remat {zcfg.remat}) fp32 masters, bf16 "
        f"compute, B={ZAMBA_TRAIN_BATCH}, S=2048: {len(losses)} steps in "
        f"{wall:.1f} s; ms a step median "
        f"{statistics.median(step_ms[1:]):.1f} (first {step_ms[0]:.1f}); "
        f"peak memory {peak / 2**30:.2f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; mean of the first 3 {a:.5f}, of the last 3 {b:.5f}")
    if not all(math.isfinite(x) for x in losses) or not b < a:
        raise AssertionError("train-hybrid: the loss is not finite or does "
                             "not fall")
    del out


def step_gap(new, ref, mu, lr):
    """(entries off the fp32 train tests' bound, the largest difference):
    1e-5, or 2 x lr where the first AdamW update's sign is not determined
    (the gradient, mu / (1 - b1), below 1e-4 of its leaf's largest)."""
    import torch
    import torch.utils._pytree as pytree
    bad, worst = 0, 0.0
    for a, b, g in zip(pytree.tree_leaves(new), pytree.tree_leaves(ref),
                       pytree.tree_leaves(mu)):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        d = (a - b).abs()
        tiny = g.abs() < 1e-4 * g.abs().max()
        bad += int((d > torch.where(tiny, 2 * lr, 1e-5)).sum())
        worst = max(worst, float(d.max()))
    return bad, worst


def phase_mesh_step():
    """A train step of smollm-135m at full width on a (1, 1, 1) mesh
    with NCCL at world size 1, against the single-device step."""
    import dataclasses
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import distributed
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw, schedule
    from repro_torch.train import train_loop

    cfg = dataclasses.replace(get_config("smollm-135m"),
                              compute_dtype="float32")
    B, S = MESH_BATCH
    params = bridge.init_params(cfg, seed=0, device="cuda",
                                keep_param_dtype=True)
    data = SyntheticLM(cfg.vocab, S, B, seed=1)
    opt_cfg = adamw.AdamWConfig(lr=MESH_LR, schedule=schedule.constant())

    def timed_step(step, p, o, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(p, o, batch)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    (p1, o1, m1), one_ms = timed_step(train_loop.make_train_step(
        cfg, opt_cfg), params, adamw.init(params), data.batch_at(0))
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        distributed.init_distributed(store=store, world_size=1, rank=0,
                                     device_type="cuda")
        try:
            mesh = mesh_lib.make_mesh((1, 1, 1), ("data", "model", "stage"),
                                      "cuda")
            rules = model_zoo.make_rules(cfg, mesh)
            placed = train_loop.place_params(params, cfg, rules)
            step = train_loop.make_train_step(cfg, opt_cfg, rules)
            (p2, o2, m2), first_ms = timed_step(step, placed,
                                                adamw.init(placed),
                                                data.batch_at(0))
            (p3, o3, _), again_ms = timed_step(step, p2, o2,
                                               data.batch_at(1))
            want = [rules.sharding(a) for a in pytree.tree_leaves(
                model_zoo.param_axes(cfg),
                is_leaf=lambda x: isinstance(x, tuple))]
            for tree in (p2, o2.mu, o2.nu, p3, o3.mu, o3.nu):
                leaves = pytree.tree_leaves(tree)
                if not all(isinstance(t, DTensor) and tuple(t.placements)
                           == w for t, w in zip(leaves, want)):
                    raise AssertionError("a master or moment left its "
                                         "placements")
            log(f"[mesh] backend {dist.get_backend()}, world size "
                f"{dist.get_world_size()}, mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}; placements: "
                f"embed {p2['embed'].placements}, layers.mlp.w_gate "
                f"{p2['layers']['mlp']['w_gate'].placements}, "
                f"layers.attn.wq {p2['layers']['attn']['wq'].placements}")
        finally:
            dist.destroy_process_group()
    bad, worst = step_gap(p2, p1, o1.mu, MESH_LR)
    loss1, loss2 = float(m1["loss"]), float(m2["loss"])
    log(f"[mesh] smollm-135m ({model_zoo.count_params(cfg) / 1e6:.1f}M) "
        f"fp32, B={B} S={S}: loss {loss2:.6f} on the mesh, {loss1:.6f} on "
        f"one device; largest leaf difference {worst:.3g}, {bad} entries "
        f"off the bound; step {first_ms:.1f} ms on the mesh (first), "
        f"{again_ms:.1f} ms (second), {one_ms:.1f} ms on one device")
    if abs(loss2 - loss1) > 1e-5 * abs(loss1) or bad:
        raise AssertionError("the mesh step differs from the single-device "
                             "step")


def phase_pipelined_accum():
    """accum="pipeline" (4 stages) against accum="fori" at smollm-135m
    full width, off the mesh."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import pipeline
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw, schedule
    from repro_torch.train import train_loop

    M = N = PIPE_STAGES
    cfg = dataclasses.replace(get_config("smollm-135m"),
                              compute_dtype="float32", grad_accum=M)
    B, S = PIPE_BATCH
    tree = 4 * model_zoo.count_params(cfg)
    # the stacked per-microbatch gradients in, the drained ones out and
    # their stack, a tree per slot and the zero slot
    log(f"[pipeline] reckoned: one fp32 gradient tree {tree / 1e9:.3f} GB; "
        f"the schedule holds about {3 * M + N + 1} of them "
        f"({(3 * M + N + 1) * tree / 1e9:.2f} GB)")
    params = bridge.init_params(cfg, seed=0, device="cuda",
                                keep_param_dtype=True)
    batch = SyntheticLM(cfg.vocab, S, B, seed=2).batch_at(0)
    opt_cfg = adamw.AdamWConfig(lr=MESH_LR, schedule=schedule.constant())
    fori = train_loop.make_train_step(cfg, opt_cfg, None, True, "fori")
    pipe = train_loop.make_train_step(cfg, opt_cfg, None, True, "pipeline",
                                      N)
    pf, of, mf = fori(params, adamw.init(params), batch)
    pipe(params, adamw.init(params), batch)            # first call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipeline.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    pp, op, mp = pipe(params, adamw.init(params), batch)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    steps = pipeline.COUNTS["steps"]
    bad, worst = step_gap(pp, pf, of.mu, MESH_LR)
    log(f"[pipeline] smollm-135m fp32, B={B} S={S}, {M} microbatches over "
        f"{N} stages: {steps} schedule steps, {pipeline.COUNTS['stage_calls']}"
        f" stage calls; train step {ms:.1f} ms (CUDA events), "
        f"{ms / steps:.1f} ms a schedule step; peak memory "
        f"{peak / 2**30:.2f} GiB; loss {float(mp['loss']):.6f} against "
        f"fori's {float(mf['loss']):.6f}; largest leaf difference "
        f"{worst:.3g}, {bad} entries off the bound")
    if steps != M + N - 1 or pipeline.COUNTS["stage_calls"] != M * N:
        raise AssertionError("the schedule did not take M + S - 1 steps")
    if abs(float(mp["loss"]) - float(mf["loss"])) > 1e-5 * float(mf["loss"]) \
            or bad:
        raise AssertionError("pipelined accumulation differs from fori")


def phase_dist_loop():
    """distributed_while off the mesh; parallel_iterations under the
    graph lowering."""
    import math
    import torch
    from repro_torch import core
    from repro_torch.core import device_loop
    from repro_torch.dist import pipeline

    x = torch.linspace(0.5, 1.5, 128, device="cuda").reshape(8, 4, 4)
    want = x * 1.0001 ** 50
    for barrier in (False, True):
        y = pipeline.distributed_while(lambda v: v * 1.0001, 50, x,
                                       barrier=barrier)(x)
        err = float((y - want).abs().max())
        log(f"[loop] distributed_while barrier={barrier}: 50 iterations, "
            f"max |y - x * 1.0001^50| {err:.3g}")
        if err > 1e-5 * float(want.abs().max()):
            raise AssertionError("distributed_while is off")

    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(128, 128, generator=gen) / 11.3).cuda()
    x0 = torch.randn(8, 128, generator=gen).cuda()
    out = {}
    for par in (1, LOOP_WINDOW):
        x = x0.clone()
        k = torch.zeros((), dtype=torch.int32, device="cuda")

        def body(c):
            return torch.tanh(c[0] @ w), c[1] + 1

        with torch.no_grad():
            body((x0, k))                    # lazy init outside capture
            core.while_loop(None, body, (x, k), max_iters=WINDOW_ITERS,
                            impl="graph", parallel_iterations=par)
            loop = core.while_loop.last_loop
            got = (x.clone(), int(k), loop.iterations(), loop.remainder)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                loop.run()
            end.record()
            torch.cuda.synchronize()
        out[par] = got + (start.elapsed_time(end) / 5,)
        device_loop.release(body)
        log(f"[loop] {WINDOW_ITERS} tanh(x @ w) bodies, "
            f"parallel_iterations={par}: {got[2]} loop steps "
            f"({got[2] - bool(got[3])} WHILE-node iterations of window "
            f"{par}, a remainder step of {got[3]}), {got[1]} bodies, "
            f"{out[par][4]:.3f} ms a replay")
    n_w = math.ceil(WINDOW_ITERS / LOOP_WINDOW)
    n = WINDOW_ITERS
    if (out[1][2], out[LOOP_WINDOW][2]) != (n, n_w) \
            or (out[1][3], out[LOOP_WINDOW][3]) != (0, n % LOOP_WINDOW) \
            or (out[1][1], out[LOOP_WINDOW][1]) != (n, n):
        raise AssertionError("the unroll window's trip counts are off")
    if not torch.equal(out[1][0], out[LOOP_WINDOW][0]):
        raise AssertionError("parallel_iterations changed the carry")


# ------------------------------------------- multi-device part two (39-41)

_LLAMA = {}


def llama_bf16():
    """llama3.2-1b at full width, bf16, ``attn_impl="cuda"``, its weights
    from seed 0, drawn once for the phases that serve it as is (4, 17,
    19, 20, 26 and 39) and freed after phase 39 (``release_llama``)."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config
    if not _LLAMA:
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  attn_impl="cuda")
        _LLAMA["cfg"] = cfg
        _LLAMA["params"] = bridge.init_params(cfg, seed=0, device="cuda")
    return _LLAMA["cfg"], _LLAMA["params"]


def release_llama():
    _LLAMA.clear()


def world_of_one():
    """A process group of one rank over NCCL (a ``FileStore`` in a
    temporary directory), as phase 36 makes it; a context manager."""
    import contextlib
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import distributed

    @contextlib.contextmanager
    def group():
        with tempfile.TemporaryDirectory() as tmp:
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            distributed.init_distributed(store=store, world_size=1, rank=0,
                                         device_type="cuda")
            try:
                yield
            finally:
                dist.destroy_process_group()
    return group()


def phase_mesh_serve():
    """Phase 4's pool and requests (llama3.2-1b full width, bf16, 8
    slots, chunked, paged, both kernels) through ``DecodeScheduler(rules=,
    mesh=)`` on a (1,) data mesh over NCCL at world size 1, against the
    mesh-less scheduler: tokens bit for bit, the same lowering, tok/s of
    both."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    cfg, params = llama_bf16()
    reqs = serving_requests(cfg)
    smi = card_label()
    with world_of_one():
        mesh = mesh_lib.make_mesh((1,), ("data",), "cuda")
        rules = model_zoo.make_rules(cfg, mesh)
        got = {}
        for tag, kw in (("mesh-less", {}),
                        ("mesh", dict(rules=rules, mesh=mesh))):
            s = make_scheduler(params, cfg, **kw)
            s.warmup()
            drive(s, reqs[:2])                        # the first segments
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streams = drive(s, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tokens = sum(len(t) for t in streams.values())
            got[tag] = (streams, s.loop_impl, s.pool_layout, tokens / wall,
                        s.device_launches)
            s.close()
        log(f"[mesh-serve] {smi}: {cfg.name} bf16, 8 slots, {len(reqs)} "
            f"requests, backend {dist.get_backend()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
            + "; ".join(f"{tag} {v[3]:.1f} tok/s ({v[1]}, pool {v[2]}, "
                        f"paged_attention {v[4]['paged_attention']}, "
                        f"flash_prefill {v[4]['flash_prefill']})"
                        for tag, v in got.items()))
    a, b = got["mesh-less"], got["mesh"]
    same = sum(bool(np.array_equal(a[0][i], b[0][i])) for i in a[0])
    log(f"[mesh-serve] streams equal: {same}/{len(reqs)}; lowering "
        f"{a[1]} / {b[1]}")
    if same != len(reqs) or a[1] != "cuda-graph:while" or b[1] != a[1] \
            or b[2] != "single" or b[4] != a[4]:
        raise AssertionError("the mesh of one serves otherwise than no mesh")


def disagg_mesh_rank(want32):
    """One rank of phase 40: its tier of the 1 + 1 split, bf16 then fp32
    (weights drawn from seed 0 in each)."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    pf, de = sh.carve_slices(1)
    meshes = dict(prefill_mesh=sh.slice_mesh(pf, device_type="cuda"),
                  decode_mesh=sh.slice_mesh(de, device_type="cuda"))
    reqs = disagg_requests()
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  attn_impl="cuda", compute_dtype=dtype)
        params = bridge.init_params(cfg, seed=0, device="cuda")
        d = make_disagg(params, cfg, **meshes)
        tier = d.prefill if d.prefill is not None else d.decode
        d.warmup()
        for plen in (8, 512):                 # both widths, ship, splice
            d.submit(np.full((1, plen), 2, np.int32), max_new=1,
                     request_id=10_000 + plen)
            d.run_until_drained()
        d.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = drive(d, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_drained(f"disagg mesh {d._role} tier", tier)
        if dtype == "bfloat16":
            out.update(
                role=d._role, finished=len(streams), wall_s=wall,
                tok_s=sum(len(t) for t in streams.values()) / wall,
                transfers=d.transfers, transfer_bytes=d.transfer_bytes,
                transfer_ms=list(d.transfer_ms),
                transfer_impl=d.transfer_impl,
                launches=tier.device_launches, loop=tier.loop_impl,
                reads=(tier.host_reads, tier.segments),
                layout=tier.pool_layout)
        else:
            out["fp32_equal"] = sum(
                bool(np.array_equal(streams[i], want32[i])) for i in want32)
        d.close()
        del d, tier, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_disagg_mesh(colocated):
    """The disaggregation of phase 26 on disjoint slices: two ranks
    spawned on ``cuda:0`` (NCCL refuses two ranks on one card), joined
    by gloo over a ``FileStore``, split 1 + 1 (``carve_slices(1)``), at
    llama3.2-1b full width on phase 26's mix. Gates: every request
    finishes, ``transfers == 32``, ``paged_attention`` launched on the
    decode rank and ``flash_prefill`` on the prefill rank, nothing
    gathers, both pools drain; in fp32 the streams equal phase 26's
    colocated fp32 streams. The two ranks time-share the one card, so
    the numbers are the split's cost on one card, not multi-device
    speed."""
    import numpy as np
    from repro_torch.launch.distributed import run_local
    smi = card_label()
    ranks = run_local(disagg_mesh_rank, 2, colocated["fp32_streams"],
                      device_type="cuda", backend="gloo", timeout=600)
    pf = next(r for r in ranks if r["role"] == "prefill")
    de = next(r for r in ranks if r["role"] == "decode")
    n = len(disagg_requests())
    ms = np.asarray(de["transfer_ms"])
    log(f"[disagg-mesh] {smi}: 1 + 1 ranks on one card ({de['backend']}, "
        f"time-shared), {de['transfer_impl']}: {de['finished']} of {n} "
        f"finished, {de['tok_s']:.1f} tok/s over {de['wall_s']:.2f} s "
        f"(phase 26 on one process: colocated "
        + ", ".join(f"{x:.1f}" for x in colocated["colocated_tok_s"])
        + ", disaggregated "
        + ", ".join(f"{x:.1f}" for x in colocated["disagg_tok_s"])
        + f" tok/s); {de['transfers']} transfers, "
        f"{de['transfer_bytes'] / 1e6:.2f} MB, transfer ms p50/p99 "
        f"{np.percentile(ms, 50):.3f}/{np.percentile(ms, 99):.3f} (host "
        f"wall of the two broadcasts on the decode rank); prefill rank "
        f"{pf['launches']}, {pf['loop']}, pool {pf['layout']}; decode rank "
        f"{de['launches']}, {de['loop']}, pool {de['layout']}")
    log(f"[disagg-mesh] fp32 streams equal phase 26's colocated ones: "
        f"{de['fp32_equal']}/{n} (decode rank), {pf['fp32_equal']}/{n} "
        f"(prefill rank's router)")
    if len(colocated["fp32_streams"]) != n or \
            de["finished"] != n or pf["finished"] != n or \
            de["transfers"] != n or \
            de["launches"]["paged_attention"] == 0 or \
            pf["launches"]["flash_prefill"] == 0 or \
            de["launches"]["gather"] or pf["launches"]["gather"] or \
            de["fp32_equal"] != n or pf["fp32_equal"] != n:
        raise AssertionError("the 1 + 1 disaggregation failed a gate")


def phase_mesh_ckpt():
    """``launch.train --mesh 1,1,1 --ckpt-dir`` at smollm-135m full width
    (fp32 masters) on NCCL at world size 1: an uninterrupted run of 4
    steps checkpoints at 2 and 4; with step 4's checkpoint removed, a
    fresh run resumes at 2 and trains to 4, and its parameters equal the
    uninterrupted run's bit for bit (deterministic algorithms on, so that
    the embedding's backward adds its rows in one order)."""
    import os
    import shutil
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo
    cfg = get_config("smollm-135m")
    root = checkpoint_root(3 * 4 * model_zoo.count_params(cfg))
    argv = ["--arch", "smollm-135m", "--steps", "4", "--batch", "8",
            "--seq", "256", "--mesh", "1,1,1", "--ckpt-dir", root,
            "--ckpt-every", "2"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        first = launch_train.main(argv)
        want = [t.full_tensor() for t in pytree.tree_leaves(first["params"])]
        placements = {str(t.placements) for t in
                      pytree.tree_leaves(first["params"])}
        saved = sorted(os.listdir(root))
        shutil.rmtree(os.path.join(root, "step_000000004"))
        again = launch_train.main(argv)
        got = [t.full_tensor() for t in pytree.tree_leaves(again["params"])]
        wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    same = sum(bool(torch.equal(a, b)) for a, b in zip(got, want))
    log(f"[mesh-ckpt] {card_label()}: smollm-135m fp32 masters, mesh "
        f"(1, 1, 1) over NCCL at world size 1 (placements {placements}): "
        f"checkpoints {saved}; resumed at step {again['start']} of 4: "
        f"{same}/{len(want)} leaves bit-equal to the uninterrupted run's; "
        f"{wall:.1f} s")
    if again["start"] != 2 or saved != ["step_000000002",
                                        "step_000000004"] \
            or same != len(want):
        raise AssertionError("the sharded resume is not exact")


def ep_setup():
    """(config, AdamW config, batch) of phase 42."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw, schedule
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              n_layers=MOE_TRAIN_LAYERS,
                              compute_dtype="float32")
    B, S = EP_BATCH
    return (cfg, adamw.AdamWConfig(lr=MESH_LR, schedule=schedule.constant()),
            SyntheticLM(cfg.vocab, S, B, seed=0).batch_at(0))


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def expert_parallel_rank(ref_path):
    """One rank of phase 42: the step on the (1, 2) mesh from weights
    drawn from seed 0, its updated leaves held to the one-rank step's
    (read from ``ref_path``, this rank's slice of each), and a second
    step timed."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import distributed
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo, moe
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop
    cfg, opt_cfg, batch = ep_setup()
    mesh = mesh_lib.make_mesh(EP_MESH, ("data", "model"), "cuda")
    rules = model_zoo.make_rules(cfg, mesh)
    params = bridge.init_params(cfg, seed=0, device="cuda",
                                keep_param_dtype=True)
    placed = train_loop.place_params(params, cfg, rules)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    step = train_loop.make_train_step(cfg, opt_cfg, rules)
    seen, cols = set(), set()
    plain, plain_nll = moe.expert_swiglu, model_zoo._VocabParallelNLL

    def swiglu(be, w_gate, *rest):
        seen.add(tuple(w_gate.shape))
        return plain(be, w_gate, *rest)

    class Recorded(plain_nll):
        @staticmethod
        def forward(ctx, x, labels, w, *rest):
            cols.add(tuple(w.shape))
            return plain_nll.forward(ctx, x, labels, w, *rest)

    moe.expert_swiglu, model_zoo._VocabParallelNLL = swiglu, Recorded
    walls = []
    try:
        torch.cuda.reset_peak_memory_stats()
        sh.reset_counts()
        opt = adamw.init(placed)
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, opt, m = step(placed, opt, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                peak = torch.cuda.max_memory_allocated()
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                ref = torch.load(ref_path, mmap=True)
                bad, worst = {}, {}
                for path in EP_LEAVES:
                    a = leaf(new, path)
                    want, tiny = ref["/".join(path)]
                    at = tuple(slice(sh.local_offset(a, d),
                                     sh.local_offset(a, d) + n)
                               for d, n in enumerate(a.to_local().shape))
                    d = (a.to_local() - want[at].cuda()).abs()
                    tol = torch.where(tiny[at].cuda(), 2 * MESH_LR, 1e-5)
                    bad["/".join(path)] = int((d > tol).sum())
                    worst["/".join(path)] = float(d.max())
                del ref
                local = {"/".join(p): tuple(leaf(new, p).to_local().shape)
                         for p in EP_LEAVES}
                expert_bytes = sum(
                    leaf(new, p).to_local().numel() * 4 for p in EP_LEAVES
                    if p[-1].startswith("w_"))
            placed = new
    finally:
        moe.expert_swiglu, model_zoo._VocabParallelNLL = plain, plain_nll
    return dict(rank=dist.get_rank(), backend=dist.get_backend(),
                staged=list(distributed.STAGED), loss=loss, grad_norm=gnorm,
                bad=bad, worst=worst, counts=dict(sh.COUNTS), local=local,
                seen=sorted(seen), cols=sorted(cols), peak=peak,
                expert_bytes=expert_bytes,
                walls=walls,
                routes={a: rules.mesh_axes(a) for a in (
                    sh.EXPERT, sh.EXPERT_MLP, sh.VOCAB)})


def phase_expert_parallel():
    """qwen2-moe-a2.7b's train step on a (1, 2) data x model mesh of two
    gloo ranks on ``cuda:0`` (``EXPERT`` and the vocab-parallel CE bound
    to ``model``) against the one-rank step, which runs first here and
    is freed before the ranks start (each takes about half of its
    memory)."""
    import os
    import tempfile
    import torch
    from repro_torch import bridge
    from repro_torch.launch.distributed import run_local
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop
    smi = card_label()
    cfg, opt_cfg, batch = ep_setup()
    torch.cuda.reset_peak_memory_stats()
    params = bridge.init_params(cfg, seed=0, device="cuda",
                                keep_param_dtype=True)
    step = train_loop.make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, opt, m = step(params, adamw.init(params), batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    ref = {}
    for path in EP_LEAVES:
        mu = leaf(opt.mu, path)
        ref["/".join(path)] = (leaf(new, path).cpu(),
                               (mu.abs() < 1e-4 * mu.abs().max()).cpu())
    whole_expert_bytes = sum(leaf(params, p).numel() * 4 for p in EP_LEAVES
                             if p[-1].startswith("w_"))
    del params, new, opt, m, step, mu
    free_device_memory("the expert-parallel ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        path = os.path.join(tmp, "one_rank.pt")
        torch.save(ref, path)
        del ref
        t0 = time.perf_counter()
        ranks = run_local(expert_parallel_rank, 2, path, device_type="cuda",
                          backend="gloo", timeout=600)
        wall = time.perf_counter() - t0
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    m = EP_MESH[1]
    log(f"[expert-parallel] {smi}: {cfg.name} full width, "
        f"{MOE_TRAIN_LAYERS} layers ({model_zoo.count_params(cfg) / 1e9:.3f}B"
        f" params), fp32, B={EP_BATCH[0]} S={EP_BATCH[1]}, mesh "
        f"data x model {EP_MESH}, two ranks on cuda:0 over "
        f"{ranks[0]['backend']} (time-shared), staged through host memory: "
        f"{ranks[0]['staged'] or 'nothing'}; routes {ranks[0]['routes']}; "
        f"one rank: loss {loss:.7f}, grad norm {gnorm:.6f}, step "
        f"{one_s * 1e3:.1f} ms, peak {one_peak / 2**30:.2f} GiB, expert "
        f"masters {whole_expert_bytes / 1e9:.3f} GB; launch and both ranks "
        f"{wall:.1f} s")
    for r in ranks:
        log(f"[expert-parallel] {smi}: rank {r['rank']}: loss "
            f"{r['loss']:.7f}, grad norm {r['grad_norm']:.6f}; peak "
            f"{r['peak'] / 2**30:.2f} GiB (one rank: "
            f"{one_peak / 2**30:.2f} GiB); expert masters held "
            f"{r['expert_bytes'] / 1e9:.3f} GB; step walls "
            f"{', '.join(f'{w * 1e3:.1f}' for w in r['walls'])} ms; "
            f"local {r['local']}; w_gate inside the experts {r['seen']}, "
            f"the unembedding inside the CE {r['cols']}; "
            f"counts {r['counts']}; entries off the bound {r['bad']}, "
            f"largest differences {r['worst']}")
    for r in ranks:
        if abs(r["loss"] - loss) > 1e-5 * abs(loss) or \
                abs(r["grad_norm"] - gnorm) > 1e-4 * abs(gnorm) or \
                any(r["bad"].values()) or \
                r["counts"]["whole_gathers"] or \
                not r["counts"]["split_all_reduces"] or \
                r["local"]["layers/moe/w_gate"][1:] != (E // m, D, F) or \
                r["seen"] != [(E // m, D, F)] or \
                r["cols"] != [(D, cfg.padded_vocab // m)] or \
                r["local"]["unembed"] != (D, cfg.padded_vocab // m) or \
                r["routes"]["expert"] != "model" or \
                r["routes"]["vocab"] != "model":
            raise AssertionError(f"the expert-parallel step failed a gate "
                                 f"on rank {r['rank']}")


def model_requests(cfg):
    """Phase 43's requests: ``MODEL_SERVE``'s count of prompts (phase 4's
    draws) with its new tokens each."""
    n, prompt, new = MODEL_SERVE
    return [(p, new) for p, _ in serving_requests(cfg, n=n,
                                                  prompt_len=prompt)]


def model_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b"),
                               compute_dtype="float32", attn_impl="cuda")


def pool_bytes(sched):
    """(parameter bytes, K/V pool bytes) a scheduler holds."""
    import torch.utils._pytree as pytree
    node = sched.pool.cache["attn"]
    return (sum(t.numel() * t.element_size()
                for t in pytree.tree_leaves(sched.params)),
            sum(t.numel() * t.element_size()
                for t in (node.k_pool, node.v_pool)))


def record_gaps(sched):
    """``{(request id, emission index): top-2 gap}`` of every token a
    host-read scheduler samples, the gap relative to the top logit,
    filled while it runs (``sampling.sample_slots`` and the scheduler's
    one-shot admission, chunk and decode steps wrapped); returns (the
    dict, a restore function)."""
    from repro_torch.serve import sampling
    gaps, mode, plain = {}, {"now": None}, sampling.sample_slots
    steps = {k: getattr(sched, k) for k in ("_admit", "_chunk", "_decode")}

    def sample(logits, keys, sp):
        top = logits.float().topk(2, dim=-1).values
        rel = ((top[:, 0] - top[:, 1])
               / top[:, 0].abs().clamp_min(1e-30)).tolist()
        p = sched.pool
        if mode["now"] == "_admit":
            # the admitted rows' request ids (args 3 and 7 of _admit)
            rids, mask = (t.tolist() for t in mode["args"])
            rows = [(rid, 0, g) for rid, m, g in zip(rids, mask, rel) if m]
        else:
            idx = ([0] * len(rel) if mode["now"] == "_chunk"
                   else p.n_emitted.tolist())
            rows = zip(p.request_id.tolist(), idx, rel)
        for rid, j, g in rows:
            gaps[(rid, j)] = g
        return plain(logits, keys, sp)

    def wrap(name):
        def run(*a, **kw):
            mode["now"] = name
            if name == "_admit":
                mode["args"] = (a[3], a[7])
            return steps[name](*a, **kw)
        return run

    sampling.sample_slots = sample
    for name in steps:
        setattr(sched, name, wrap(name))

    def restore():
        sampling.sample_slots = plain
        for name in steps:
            delattr(sched, name)
    return gaps, restore


def model_serve_rank():
    """One rank of phase 43: the (1, 2) data x model pool on its slices
    of the weights (seed 0, drawn whole on the card and freed once
    sliced), its kernel launches and their head counts counted from 0
    just before the run."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels.flash_prefill import kernel as fp_kernel
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import distributed
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    cfg = model_cfg()
    mesh = mesh_lib.make_mesh(MODEL_MESH, ("data", "model"), "cuda")
    rules = model_zoo.make_rules(cfg, mesh)
    params = bridge.init_params(cfg, seed=0, device="cuda")
    sh.reset_counts()
    sched = make_scheduler(params, cfg, max_new_cap=MODEL_SERVE[2],
                           rules=rules, mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    heads = set()
    kernels = {"paged_attention": (pa_ops, pa_kernel.paged_attention),
               "flash_prefill": (fp_ops, fp_kernel.flash_prefill)}

    def seen(fn):
        def call(q, k_pool, *rest, **kw):
            heads.add((q.shape[2], k_pool.shape[2]))
            return fn(q, k_pool, *rest, **kw)
        return call

    for mod, fn in kernels.values():
        mod._kernel = seen(fn)
    try:
        reqs = model_requests(cfg)
        for _, fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, (_, fn) in kernels.items()}
    finally:
        for mod, fn in kernels.values():
            mod._kernel = fn
    return dict(rank=dist.get_rank(), backend=dist.get_backend(),
                staged=list(distributed.STAGED),
                streams={r: [int(t) for t in s] for r, s in streams.items()},
                wall=wall, launches=launches, heads=sorted(heads),
                bytes=pool_bytes(sched), held=held, counts=dict(sh.COUNTS),
                layout=(sched.model_layout, sched.pool_layout,
                        sched.loop_impl))


def phase_model_serve():
    """llama3.2-1b at full width in fp32 on a (1, 2) data x model mesh of
    two gloo ranks on ``cuda:0`` against the one-rank scheduler, which
    runs first here (host-read segments, each sampled token's top-2 gap
    kept) and is freed before the ranks start. Returns rank 0's kernel
    launches."""
    import torch
    from repro_torch import bridge
    from repro_torch.launch.distributed import run_local
    smi = card_label()
    cfg = model_cfg()
    reqs = model_requests(cfg)
    params = bridge.init_params(cfg, seed=0, device="cuda")
    sched = make_scheduler(params, cfg, loop="host",
                           max_new_cap=MODEL_SERVE[2])
    gaps, restore = record_gaps(sched)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = {r: [int(t) for t in s] for r, s in drive(sched, reqs).items()}
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
    finally:
        restore()
    one_bytes = pool_bytes(sched)
    del params, sched
    free_device_memory("the model-axis serving ranks")
    t0 = time.perf_counter()
    ranks = run_local(model_serve_rank, 2, device_type="cuda",
                      backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    tokens = sum(len(t) for t in want.values())
    log(f"[model-serve] {smi}: {cfg.name} full width ({cfg.n_layers} "
        f"layers, {cfg.n_heads}/{cfg.n_kv_heads} heads), fp32, 8 slots, "
        f"paged, chunked ({MODEL_SERVE[0]} prompts of {MODEL_SERVE[1]}, "
        f"{MODEL_SERVE[2]} new tokens); one rank (host-read): "
        f"{tokens / one_wall:.1f} tok/s, {one_bytes[0] / 1e9:.3f} GB of "
        f"parameters, {one_bytes[1] / 1e9:.4f} GB of K/V; mesh data x "
        f"model {MODEL_MESH}, two ranks on cuda:0 over "
        f"{ranks[0]['backend']} (time-shared, not multi-device speed), "
        f"staged through host memory: {ranks[0]['staged'] or 'nothing'}; "
        f"launch and both ranks {wall:.1f} s")
    failed = []
    for r in ranks:
        same, worst = diverging(r["streams"], want, gaps)
        p_ratio = r["bytes"][0] / one_bytes[0]
        kv_ratio = r["bytes"][1] / one_bytes[1]
        log(f"[model-serve] {smi}: rank {r['rank']}: "
            f"{tokens / r['wall']:.1f} tok/s (gloo, two ranks time-sharing "
            f"one card); layouts {r['layout']}; streams equal "
            f"{same}/{len(want)}"
            + (f", diverging (request, token, one-rank top-2 gap): "
               f"{[(a, b, f'{g:.2e}') for a, b, g in worst]}"
               if worst else "")
            + f"; parameters {r['bytes'][0] / 1e9:.3f} GB "
            f"({p_ratio:.4f} of one rank's), K/V {r['bytes'][1] / 1e9:.4f} "
            f"GB ({kv_ratio:.4f}); device memory held "
            f"{r['held'] / 2**30:.2f} GiB; kernel launches {r['launches']} "
            f"on (q heads, K/V heads) {r['heads']}; counts {r['counts']}")
        local = (cfg.n_heads // MODEL_MESH[1],
                 cfg.n_kv_heads // MODEL_MESH[1])
        if any(g >= MODEL_GAP for _, _, g in worst) or \
                r["counts"]["whole_gathers"] or \
                not r["counts"]["split_all_reduces"] or \
                not r["counts"]["vocab_gathers"] or \
                abs(p_ratio - 0.5) > 0.01 or abs(kv_ratio - 0.5) > 0.01 or \
                r["heads"] != [local] or \
                not all(r["launches"].values()) or \
                r["layout"][0] != f"split:modelx{MODEL_MESH[1]}":
            failed.append(r["rank"])
    if failed:
        raise AssertionError(f"the model-axis serving phase failed a gate on "
                             f"ranks {failed}")
    return ranks[0]["launches"]


def family_cfg(arch):
    """Phase 44's config of ``arch``: full width in fp32, its depth cut
    to ``FAMILY_LAYERS``, the kernels asked for (the scan for mamba1,
    the paged decode for attention)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              n_layers=FAMILY_LAYERS[arch])
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_impl="cuda"))
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_layers=FAMILY_LAYERS[arch])
    return dataclasses.replace(cfg, attn_impl="cuda")


def family_requests(cfg):
    """Phase 44's requests: ``FAMILY_SERVE``'s count of prompts of its
    length (whisper: 4 to ``WHISPER_PROMPT`` tokens with their frames),
    each with its new tokens."""
    n, prompt, new = FAMILY_SERVE
    if cfg.family == "audio":
        return [(p, new, f) for p, _, f in whisper_requests(cfg, n=n)]
    return moe_requests(cfg, n=n, prompt_len=prompt, max_new=new)


def make_family_scheduler(params, cfg, **kw):
    """Phase 44's pool: one-shot admission, 4 slots, the paged cache in
    blocks of 16 where the family has K/V, EOS -1."""
    from repro_torch.serve import scheduler as sched_lib
    n, prompt, new = FAMILY_SERVE
    paged = dict(kv="paged", kv_block=16) if cfg.family != "ssm" else {}
    return sched_lib.DecodeScheduler(
        params, cfg, n_slots=n, max_new_cap=new, eos_id=-1,
        prompt_len=WHISPER_PROMPT if cfg.family == "audio" else prompt,
        prefill="oneshot", **paged, **kw)


def tree_bytes(tree):
    import torch.utils._pytree as pytree
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree))


def cache_bytes(sched):
    """The bytes of each part of a pool's cache: a K/V pool's blocks
    (``attn``, ``self``), each leaf of the SSM state and the cross K/V
    (``ssm/conv``, ``cross/k``, ...)."""
    out = {}
    for key, node in sched.pool.cache.items():
        if hasattr(node, "k_pool"):
            out[key] = tree_bytes([node.k_pool, node.v_pool])
        else:
            out.update({f"{key}/{leaf}": tree_bytes([t])
                        for leaf, t in node.items()})
    return out


def rank_bytes(params, cfg, m):
    """A rank's parameter bytes under ``cfg``'s rules on a model axis of
    ``m``: each leaf the rules split an m-th; each part of a leaf of parts
    (``model_zoo.serve_parts``) an m-th where it splits, whole where not;
    every other leaf whole."""
    import torch.utils._pytree as pytree
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model_zoo
    rules = model_zoo.make_rules(cfg, {"data": 1, "model": m})
    axes = {pytree.keystr(k): a for k, a in pytree.tree_flatten_with_path(
        model_zoo.param_axes(cfg),
        is_leaf=lambda a: isinstance(a, tuple))[0]}
    parts = {"".join(f"[{k!r}]" for k in path.split("/")): v
             for path, v in model_zoo.serve_parts(cfg).items()}
    total = 0
    for path, t in pytree.tree_flatten_with_path(params)[0]:
        key, n = pytree.keystr(path), t.numel() * t.element_size()
        if key in parts:
            d = sh._model_dim(rules, axes[key], None)
            total += n // t.shape[d] * sum(w // m if split else w
                                           for w, split in parts[key])
        elif sh._model_dim(rules, axes[key], tuple(t.shape)) is not None:
            total += n // m
        else:
            total += n
    return total


def rank_cache_bytes(whole, cfg, m):
    """A rank's cache bytes on a model axis of ``m`` from the one-rank
    pool's (``cache_bytes``): an m-th of each K/V pool, of the cross K/V
    and of the SSM state, but mamba2's conv window, which keeps the whole
    B and C channels (Di/m + 2N of Di + 2N)."""
    out = {}
    for key, n in whole.items():
        if key == "ssm/conv" and cfg.ssm.kind == "mamba2":
            di, N = cfg.d_inner, cfg.ssm.d_state
            out[key] = n // (di + 2 * N) * (di // m + 2 * N)
        else:
            out[key] = n // m
    return out


FAMILY_KERNELS = ("selective_scan", "paged_attention", "flash_prefill")


def warm(sched, reqs):
    """The first request with 2 new tokens through a pool, outside the
    timed run: the first use of an op in a process costs up to 8.8 s
    (whisper-small's first drive on the H100, PERF.md §6), which the
    run's tok/s would count. Returns its wall seconds, reported apart."""
    import torch
    prompt, _, *frames = reqs[0]
    t0 = time.perf_counter()
    sched.submit(prompt, max_new=2, request_id=len(reqs),
                 **({"frames": frames[0]} if frames else {}))
    sched.run_until_drained()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def family_serve_rank():
    """One rank of phase 44: the three families in turn on the (1, 2)
    data x model mesh, each on its slices of the weights (seed 0, drawn
    whole on the card and freed once sliced), its kernel launches counted
    from 0 just before the run."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import distributed
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_zoo
    mesh = mesh_lib.make_mesh(FAMILY_MESH, ("data", "model"), "cuda")
    counters = launch_counters()
    out = {}
    for arch in FAMILY_LAYERS:
        cfg = family_cfg(arch)
        params = bridge.init_params(cfg, seed=0, device="cuda")
        sh.reset_counts()
        sched = make_family_scheduler(
            params, cfg, rules=model_zoo.make_rules(cfg, mesh), mesh=mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        reqs = family_requests(cfg)
        first = warm(sched, reqs)
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[arch] = dict(
            streams={r: [int(t) for t in s] for r, s in streams.items()},
            wall=wall, first=first, counts=dict(sh.COUNTS),
            layout=sched.model_layout,
            launches={k: getattr(*counters[k]) for k in FAMILY_KERNELS},
            gathers=getattr(*counters["gather"]),
            params=tree_bytes(sched.params), cache=cache_bytes(sched))
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    return dict(rank=dist.get_rank(), backend=dist.get_backend(),
                staged=list(distributed.STAGED), families=out)


def diverging(got, want, gaps):
    """(streams equal, [(request, first differing token, the one-rank
    top-2 gap there)])."""
    same, worst = 0, []
    for rid, toks in want.items():
        mine = got[rid]
        if mine == toks:
            same += 1
            continue
        j = next((i for i, (a, b) in enumerate(zip(mine, toks)) if a != b),
                 min(len(mine), len(toks)))
        worst.append((rid, j, gaps.get((rid, j), float("inf"))))
    return same, worst


def phase_family_model_serve():
    """falcon-mamba-7b, zamba2-1.2b and whisper-small at full width in
    fp32 (depths cut to ``FAMILY_LAYERS``) on a (1, 2) data x model mesh
    of two gloo ranks on ``cuda:0`` against the one-rank scheduler, which
    runs first here for each family (host-read segments, each sampled
    token's top-2 gap kept) and is freed before the ranks start. One
    launch of the ranks serves the three in turn. Every pool is warmed
    by one short request before its timed run. Returns rank 0's kernel
    launches of each family's path."""
    import torch
    from repro_torch import bridge
    from repro_torch.launch.distributed import run_local
    smi = card_label()
    m = FAMILY_MESH[1]
    one = {}
    for arch in FAMILY_LAYERS:
        cfg = family_cfg(arch)
        params = bridge.init_params(cfg, seed=0, device="cuda")
        sched = make_family_scheduler(params, cfg, loop="host")
        reqs = family_requests(cfg)
        first = warm(sched, reqs)
        gaps, restore = record_gaps(sched)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = {r: [int(t) for t in s]
                    for r, s in drive(sched, reqs).items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        cache = cache_bytes(sched)
        one[arch] = dict(want=want, gaps=gaps, wall=wall, first=first,
                         params=tree_bytes(params),
                         rank_params=rank_bytes(params, cfg, m),
                         cache=cache, rank_cache=rank_cache_bytes(cache, cfg,
                                                                  m))
        del params, sched, restore     # restore's closure holds sched
        free_device_memory(f"the next of phase 44's one-rank runs ({arch} "
                           f"done)")
    t0 = time.perf_counter()
    ranks = run_local(family_serve_rank, 2, device_type="cuda",
                      backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    log(f"[family-serve] {smi}: mesh data x model {FAMILY_MESH}, two ranks "
        f"on cuda:0 over {ranks[0]['backend']} (time-shared, not "
        f"multi-device speed), staged through host memory: "
        f"{ranks[0]['staged'] or 'nothing'}; {FAMILY_SERVE[0]} requests "
        f"of {FAMILY_SERVE[1]} tokens (whisper 4-{WHISPER_PROMPT}), "
        f"{FAMILY_SERVE[2]} new each, fp32, one-shot, 4 slots; launch and "
        f"both ranks {wall:.1f} s")
    failed = []
    for arch, ref in one.items():
        cfg = family_cfg(arch)
        tokens = sum(len(t) for t in ref["want"].values())
        log(f"[family-serve] {smi}: {arch} ({cfg.n_layers} layers"
            + (f", d_inner {cfg.d_inner}" if cfg.ssm else "")
            + (f", {cfg.n_heads}/{cfg.n_kv_heads} heads"
               if cfg.n_heads else "")
            + f"): one rank (host-read) {tokens / ref['wall']:.1f} tok/s "
            f"(the warm-up request before it {ref['first']:.2f} s), "
            f"parameters {ref['params'] / 1e9:.4f} GB, cache bytes "
            f"{ref['cache']}")
        for r in ranks:
            got = r["families"][arch]
            same, worst = diverging(got["streams"], ref["want"], ref["gaps"])
            ratios = {k: f"{v / ref['cache'][k]:.4f}"
                      for k, v in got["cache"].items()}
            log(f"[family-serve] {smi}: {arch} rank {r['rank']}: "
                f"{tokens / got['wall']:.1f} tok/s (gloo, two ranks "
                f"time-sharing one card; the warm-up request before it "
                f"{got['first']:.2f} s); layout {got['layout']}; streams "
                f"equal {same}/{len(ref['want'])}"
                + (f", diverging (request, token, one-rank top-2 gap): "
                   f"{[(a, b, f'{g:.2e}') for a, b, g in worst]}"
                   if worst else "")
                + f"; parameters {got['params']} B "
                f"({got['params'] / ref['params']:.4f} of one rank's; the "
                f"rules give {ref['rank_params']} B); cache {got['cache']} "
                f"(ratios {ratios}; the rules give {ref['rank_cache']}); "
                f"launches {got['launches']}, gathers {got['gathers']}; "
                f"counts {got['counts']}")
            kernel = ("selective_scan" if cfg.family == "ssm"
                      else "paged_attention")
            if any(g >= MODEL_GAP for _, _, g in worst) or \
                    got["counts"]["whole_gathers"] or \
                    not got["counts"]["split_all_reduces"] or \
                    got["layout"] != f"split:modelx{m}" or \
                    got["params"] != ref["rank_params"] or \
                    got["cache"] != ref["rank_cache"] or \
                    not got["launches"][kernel] or got["gathers"]:
                failed.append((arch, r["rank"]))
    if failed:
        raise AssertionError(f"the model-axis serving of the SSM, hybrid and "
                             f"audio families failed a gate on (family, "
                             f"rank) {failed}")
    return {f"{arch}:modelx{m}": ranks[0]["families"][arch]["launches"]
            for arch in FAMILY_LAYERS}


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
    free_device_memory("the prefix-cache phases")
    timed(phase_prefix_cache)
    timed(phase_slo)
    timed(phase_stream)
    free_device_memory("the adaptive-depth phase")
    timed(phase_adaptive, {k: launches[k] for k in ("paged_attention",
                                                    "flash_prefill")})
    free_device_memory("the disaggregation phase")
    colocated = timed(phase_disagg)
    free_device_memory("the mesh serving phase")
    timed(phase_mesh_serve)
    release_llama()
    free_device_memory("the 1 + 1 disaggregation")
    timed(phase_disagg_mesh, colocated)
    free_device_memory("the MoE serving phase")
    paths = {"llama3.2-1b": dict(launches),  # its own run's counts
             "qwen2-moe-a2.7b": timed(phase_moe_serve)}
    free_device_memory("the MoE parity phase")
    timed(phase_moe_parity)
    free_device_memory("the VLM phase")
    paths["internvl2-1b"] = timed(phase_vlm)
    free_device_memory("the adaptive-depth phase of the MoE and VLM")
    paths.update(timed(phase_adaptive_families))
    free_device_memory("the selective-scan phases")
    records.append(timed(phase_scan_kernel))
    free_device_memory("falcon-mamba-7b")
    launches["selective_scan"] = timed(phase_ssm_serve)
    free_device_memory("the fp32 parity run")
    timed(phase_ssm_parity)
    free_device_memory("the hybrid phase")
    paths["zamba2-1.2b"] = timed(phase_hybrid)
    free_device_memory("the audio serving phase")
    paths["whisper-small"] = timed(phase_whisper_serve)
    free_device_memory("the audio parity phase")
    timed(phase_whisper_parity)
    free_device_memory("the LSTM phases")
    records.append(timed(phase_lstm_kernel))
    launches["lstm_cell"] = timed(phase_dynamic_rnn)
    timed(phase_policies)
    timed(phase_graph_cond)
    timed(phase_graph_nested)
    timed(phase_nmt)
    timed(phase_dqn)
    timed(phase_examples)
    free_device_memory("the flash-attention phases")
    records.append(timed(phase_flash_kernel))
    launches["flash_attention"] = timed(phase_full_forward)
    free_device_memory("the training phase")
    timed(phase_train)
    free_device_memory("the MoE and VLM training phase")
    timed(phase_train_families)
    free_device_memory("the audio and hybrid training phase")
    timed(phase_train_whisper_zamba)
    free_device_memory("the mesh phases")
    timed(phase_mesh_step)
    free_device_memory("the pipelined accumulation")
    timed(phase_pipelined_accum)
    timed(phase_dist_loop)
    free_device_memory("the sharded checkpoint")
    timed(phase_mesh_ckpt)
    free_device_memory("the expert-parallel step")
    timed(phase_expert_parallel)
    free_device_memory("the model-axis serving phase")
    paths["llama3.2-1b:modelx2"] = timed(phase_model_serve)
    free_device_memory("the model-axis serving of the SSM, hybrid and "
                       "audio families")
    paths.update(timed(phase_family_model_serve))
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["name"] in FAMILY_KERNELS:
            # each serving path's own run, counts set to 0 just before it
            rec["path_launches"] = {arch: got[rec["name"]]
                                    for arch, got in paths.items()
                                    if rec["name"] in got}
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
