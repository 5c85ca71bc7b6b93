"""The port's CUDA kernels on the card. Every test here is marked
``cuda`` and skips where there is no NVIDIA GPU (the kernels have no CPU
mode). The file imports neither ``jax`` nor ``repro``, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Tolerances: the kernel and its plain version compute the same fp32 math
in another order: fp32 1e-4; bf16 outputs are rounded on both sides,
2e-2 (about two bf16 ulps at magnitude 1), which also covers the bf16
chunk kernel's rounding of p for its tensor-core PV product (at most
2^-8 of sum_j p_j |v_j|). The selective scan (fp32
only) is held to 1e-4 as well: its N-term dot products are summed in
another order and its multiply-adds fused, over states of magnitude up
to about 10. The LSTM cell: fp32 1e-5 (K <= 1024 products summed in
another order), bf16 2e-2; dynamic_rnn and policy gradients as stated
at each test. Flash attention: fp32 1e-5; bf16 rtol 2^-7 (one bf16
ulp: the output is rounded on both sides) with atol 2^-8 (the
tensor-core route rounds p to bf16 for PV, at most 2^-8 of
sum_j p_j |v_j|).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import bridge, core
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_prefill import kernel as fp_kernel
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.selective_scan import kernel as ss_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.models import model_zoo, rnn, transformer
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib
from repro_torch.serve.sampling import SamplingParams

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _case(kind, B, H, KV, hd, block, bpr, C, dtype, device, seed=0):
    """Shuffled table, -1 past each row's need, ragged lengths. Decode:
    a cur_len = 0 row, one position, the split edges P - 1, P, P + 1
    (the kernel's partitions hold P = 64 positions) and a full row.
    Prefill: a chunk at offset 0, one whose rows end inside a 64-key
    tile, and one running off the table."""
    rng = np.random.default_rng(seed)
    n_blocks, T = B * bpr + 3, block * bpr
    if kind == "decode":
        lens = rng.integers(1, T + 1, B)
        edges = [0, 1, 63, 64, 65][:B - 1]
        lens[:len(edges)] = np.minimum(edges, T)
        lens[-1] = T
        need = -(-lens // block)
        q = rng.standard_normal((B, 1, H, hd))
    else:
        lens = rng.integers(0, T - C, B)
        lens[0], lens[1], lens[-1] = 0, 64 - C // 2 - 1, T - C // 2
        need = -(-np.minimum(lens + C, T) // block)
        q = rng.standard_normal((B, C, H, hd))
    table = rng.permutation(n_blocks)[:B * bpr].reshape(B, bpr)
    table = np.where(np.arange(bpr)[None] < need[:, None], table, -1)
    pools = rng.standard_normal((2, n_blocks, block, KV, hd))
    dt = getattr(torch, dtype)
    return (torch.tensor(q, dtype=dt, device=device),
            torch.tensor(pools[0], dtype=dt, device=device),
            torch.tensor(pools[1], dtype=dt, device=device),
            torch.tensor(table, dtype=torch.int32, device=device),
            torch.tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(32, 8), (28, 4), (16, 16), (9, 3),
                                  (48, 2)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_kernel_matches_plain_version(cuda_device, kind, dtype, H, KV, hd,
                                      block):
    """G = 4, 7, 1, 3 (the four dense configs) and G = 24 (query rows
    split over the grid), both head widths, block sizes 8 to 32 over 160
    positions a row (three partitions of decode's 64), chunks of 40."""
    args = _case(kind, 8, H, KV, hd, block, 160 // block, 40, dtype,
                 cuda_device)
    kern, plain = ((pa_kernel.paged_attention, paged_attention_ref)
                   if kind == "decode"
                   else (fp_kernel.flash_prefill, flash_prefill_ref))
    before = kern.launches
    out = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if kind == "decode":
        assert torch.count_nonzero(out[0]) == 0          # cur_len == 0


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    q, kp, vp, table, lens = _case("decode", 2, 8, 2, 32, 16, 2, 1,
                                   "float32", cuda_device)
    with pytest.raises(ValueError, match="hd"):
        pa_kernel.paged_attention(q, kp, vp, table, lens)
    q, kp, vp, table, lens = _case("decode", 2, 8, 2, 64, 16, 2, 1,
                                   "float32", cuda_device)
    with pytest.raises(TypeError):
        pa_kernel.paged_attention(q.half(), kp.half(), vp.half(), table,
                                  lens)
    with pytest.raises(TypeError):
        pa_kernel.paged_attention(q, kp, vp, table.long(), lens)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_kernel_rejects_misaligned_operand(cuda_device, kind):
    """A contiguous view that starts 2 bytes into its buffer: the
    kernels read with 16-byte copies, so the wrapper refuses it."""
    args = list(_case(kind, 3, 8, 2, 64, 16, 6, 8, "bfloat16",
                      cuda_device))
    kern = (pa_kernel.paged_attention if kind == "decode"
            else fp_kernel.flash_prefill)
    for i in (0, 1):                                    # q, then k_pool
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                          device=cuda_device)
        bad = buf[1:].view(args[i].shape)
        bad.copy_(args[i])
        assert bad.is_contiguous() and bad.data_ptr() % 16
        before = kern.launches
        with pytest.raises(ValueError, match="aligned"):
            kern(*args[:i], bad, *args[i + 1:])
        assert kern.launches == before


def _offset_view(t, elems):
    """A contiguous copy of ``t`` that starts ``elems`` elements into its
    buffer."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,i", [
    ("decode", "bfloat16", 4),       # cur_len at an odd int offset
    ("decode", "float32", 3),        # the table at an odd int offset
    ("prefill", "bfloat16", 4),      # q_off at an odd int offset
    ("prefill", "float32", 0),       # fp32 q 4 bytes in: read per element
    ("prefill", "float32", 1),       # fp32 k_pool 4 bytes in
])
def test_kernel_takes_operands_it_reads_narrowly(cuda_device, kind, dtype,
                                                 i):
    """The int32 operands are read one int at a time and the fp32 chunk
    route reads q and the pools one element at a time, so a contiguous
    view at a 4-byte offset is taken, launched and right."""
    args = list(_case(kind, 6, 8, 2, 64, 16, 6, 8, dtype, cuda_device,
                      seed=5))
    args[i] = _offset_view(args[i], 1)
    assert args[i].data_ptr() % 16
    kern, plain = ((pa_kernel.paged_attention, paged_attention_ref)
                   if kind == "decode"
                   else (fp_kernel.flash_prefill, flash_prefill_ref))
    before = kern.launches
    out = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 8])
def test_flash_verify_matches_plain_version(cuda_device, W, dtype, block):
    """The chunk kernel's verify entry on speculative windows (W = k+1)
    at llama3.2-1b's geometry, q_off on the decode kernel's partition
    edges (63, 64, 65) and at 0, a window running past the table; counted
    as flash_verify, not flash_prefill."""
    rng = np.random.default_rng(W * block)
    B, H, KV, hd, bpr = 6, 32, 8, 64, 160 // block
    T = block * bpr
    q_off = np.array([0, 63, 64, 65, 100, T - W // 2], np.int32)
    need = -(-np.minimum(q_off + W, T) // block)
    n_blocks = B * bpr + 3
    table = rng.permutation(n_blocks)[:B * bpr].reshape(B, bpr)
    table = np.where(np.arange(bpr)[None] < need[:, None], table, -1)
    dt = getattr(torch, dtype)

    def t(a, d=dt):
        return torch.tensor(a, dtype=d, device=cuda_device)
    args = (t(rng.standard_normal((B, W, H, hd))),
            t(rng.standard_normal((n_blocks, block, KV, hd))),
            t(rng.standard_normal((n_blocks, block, KV, hd))),
            t(table, torch.int32), t(q_off, torch.int32))
    before = (fp_kernel.flash_verify.launches,
              fp_kernel.flash_prefill.launches)
    out = fp_kernel.flash_verify(*args)
    torch.cuda.synchronize()
    assert (fp_kernel.flash_verify.launches,
            fp_kernel.flash_prefill.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(out.float(), flash_prefill_ref(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_graph_segment_equals_host_read_on_card(cuda_device,
                                                            temperature):
    """A smoke model (hd 64) speculating through the chunked paged
    scheduler on the card in fp32: graph segments give the host-read
    segments' streams (greedy and sampled) and verify launches, counted
    on the device; greedy speculative streams equal the non-speculative
    graph run's; the kernel path never gathers."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", head_dim=64,
                              n_heads=8, n_kv_heads=2, d_model=128,
                              attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(2)
    reqs = [(np.resize(rng.integers(2, cfg.vocab, 4), n)[None].astype(
        np.int32), m) for n, m in ((30, 9), (7, 12), (25, 5), (12, 8))]
    sp = SamplingParams(temperature=temperature)
    runs = {}
    for name, loop, spec in (("graph", "graph", True),
                             ("host", "host", True),
                             ("plain", "graph", False)):
        sched = sched_lib.DecodeScheduler(
            params, cfg, n_slots=2, prompt_len=32, max_new_cap=12,
            eos_id=-1, kv="paged", kv_block=16, prefill="chunked",
            chunk_tokens=8, loop=loop, sampling=sp, seed=4,
            speculative=spec_lib.SpecConfig(k=3, ngram=1) if spec else None)
        sched.warmup()
        v0 = fp_kernel.flash_verify.launches
        g0 = kvc.PagedView.gather_calls
        for rid, (p, m) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid)
        streams = {f.request_id: f.tokens for f in sched.run_until_drained()}
        torch.cuda.synchronize()
        runs[name] = (streams, fp_kernel.flash_verify.launches - v0,
                      kvc.PagedView.gather_calls - g0, sched.spec_windows,
                      sched.total_steps)
        sched.close()
    (g, gv, gg, gw, gs), (h, hv, hg, hw, hs) = runs["graph"], runs["host"]
    # one verify launch a layer in each decode-branch run, counted on the
    # device in the graph and in Python in the host-read run
    assert gv == hv > 0 and gv % cfg.n_layers == 0
    assert gg == hg == 0 and gw == hw > 0 and gs == hs
    assert runs["plain"][1] == 0
    for rid, (_, m) in enumerate(reqs):
        assert len(g[rid]) == m
        np.testing.assert_array_equal(g[rid], h[rid])
        if temperature == 0.0:
            np.testing.assert_array_equal(g[rid], runs["plain"][0][rid])


@pytest.mark.cuda
def test_scheduler_kernel_path_equals_gather_path_on_card(cuda_device):
    """A smoke model through the chunked paged scheduler on the card:
    the kernel path's greedy streams equal the gather path's in fp32,
    and the kernel path never gathers."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", head_dim=64,
                              n_heads=8, n_kv_heads=2, d_model=128)
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(2, cfg.vocab, (1, n)).astype(np.int32), m)
            for n, m in ((30, 9), (7, 12), (25, 5), (1, 8), (18, 10))]
    streams = {}
    for impl in ("cuda", "gather"):
        sched = sched_lib.DecodeScheduler(
            params, dataclasses.replace(cfg, attn_impl=impl), n_slots=2,
            prompt_len=32, max_new_cap=12, eos_id=-1, kv="paged",
            kv_block=16, prefill="chunked", chunk_tokens=8)
        for rid, (p, m) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid)
        gathers = kvc.PagedView.gather_calls
        streams[impl] = {f.request_id: f.tokens
                         for f in sched.run_until_drained()}
        if impl == "cuda":
            assert kvc.PagedView.gather_calls == gathers
            assert sched.attn_impl == "cuda-paged:sm_90a"
    for rid, (_, m) in enumerate(reqs):
        assert len(streams["cuda"][rid]) == m
        np.testing.assert_array_equal(streams["cuda"][rid],
                                      streams["gather"][rid])


def _scan_case(B, Q, Di, N, device, seed=0):
    """Operands of one selective-scan chunk as mamba1_forward makes
    them: softplus'd steps, A = -exp(A_log), and a non-zero h0."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    dt = np.log1p(np.exp(rng.standard_normal((B, Q, Di)) - 1.0))
    A = -np.exp(0.5 * rng.standard_normal((Di, N)))
    return (t(dt), t(A), t(rng.standard_normal((B, Q, N))),
            t(rng.standard_normal((B, Q, N))),
            t(rng.standard_normal((B, Q, Di))),
            t(rng.standard_normal((B, Di, N))))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,Di,N", [
    (8, 128, 8192, 16),      # falcon-mamba-7b serving chunk
    (1, 128, 8192, 16),      # one row
    (3, 13, 128, 8),         # smoke width, odd Q
    (2, 200, 320, 16),       # 25 stages of 8 steps; 5 CTAs of 64 channels
    (1, 1, 128, 8),
    (8, 512, 8192, 16),      # one layer of a 512-token admission, one call
    (3, 1, 324, 16)])        # Q = 1; Di ragged in a CTA and in a warp
def test_selective_scan_matches_plain_version(cuda_device, B, Q, Di, N):
    args = _scan_case(B, Q, Di, N, cuda_device)
    before = ss_kernel.selective_scan.launches
    y, h = ss_kernel.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss_kernel.selective_scan.launches == before + 1
    y_ref, h_ref = selective_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_selective_scan_rejects_what_it_cannot_take(cuda_device):
    args = list(_scan_case(2, 8, 128, 8, cuda_device))
    with pytest.raises(TypeError):
        ss_kernel.selective_scan(*[a.double() for a in args])
    with pytest.raises(ValueError, match="d_state"):
        wide = _scan_case(2, 8, 128, 32, cuda_device)
        ss_kernel.selective_scan(*wide)
    strided = args[:4] + [args[4].transpose(0, 1)] + args[5:]
    with pytest.raises(ValueError):
        ss_kernel.selective_scan(*strided)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N,Q", [
    (8, 512, 8192, 16, 128),   # a 512-token admission's layer, 4 chunks
    (2, 200, 324, 8, 50),      # chunks off the kernel's 8-step stages
    (3, 45, 128, 16, 1)])      # one step a launch
def test_selective_scan_one_launch_equals_chunk_chain(cuda_device, B, S, Di,
                                                      N, Q):
    """One launch over S steps equals, bit for bit, the chain of S / Q
    launches carrying h_out to the next h0."""
    dt, A, B_, C_, x, h0 = _scan_case(B, S, Di, N, cuda_device, seed=3)
    y, h = ss_kernel.selective_scan(dt, A, B_, C_, x, h0)
    ys, hc = [], h0
    for c in range(0, S, Q):
        sl = slice(c, c + Q)
        yc, hc = ss_kernel.selective_scan(
            dt[:, sl].contiguous(), A, B_[:, sl].contiguous(),
            C_[:, sl].contiguous(), x[:, sl].contiguous(), hc)
        ys.append(yc)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.cat(ys, dim=1))
    assert torch.equal(h, hc)


@pytest.mark.cuda
def test_selective_scan_rejects_unsupported_di_and_alignment(cuda_device):
    """The TMA maps need Di % 4 == 0 and 16-byte-aligned dt, x, B_, C_:
    anything else is refused with the reason, never run another way."""
    with pytest.raises(ValueError, match="Di % 4"):
        ss_kernel.selective_scan(*_scan_case(2, 8, 130, 8, cuda_device))
    dt, A, B_, C_, x, h0 = _scan_case(2, 9, 128, 8, cuda_device)
    shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:]
    shifted = shifted.view(x.shape).copy_(x)      # contiguous, 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ss_kernel.selective_scan(dt, A, B_, C_, shifted, h0)


@pytest.mark.cuda
def test_ssm_scheduler_kernel_path_equals_blocked_path_on_card(cuda_device):
    """falcon-mamba smoke through the one-shot scheduler on the card:
    the selective-scan kernel's greedy streams equal the plain blocked
    scan's in fp32, and the kernel launches."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b", smoke=True),
                              compute_dtype="float32")
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(2, cfg.vocab, (1, 24)).astype(np.int32), m)
            for m in (9, 4, 12, 7, 10)]
    streams = {}
    for impl in ("cuda", "blocked"):
        c = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_impl=impl))
        sched = sched_lib.DecodeScheduler(params, c, n_slots=2,
                                          prompt_len=24, max_new_cap=12,
                                          eos_id=-1)
        for rid, (p, m) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid)
        before = ss_kernel.selective_scan.launches
        streams[impl] = {f.request_id: f.tokens
                         for f in sched.run_until_drained()}
        launched = ss_kernel.selective_scan.launches - before
        assert (launched > 0) == (impl == "cuda")
        assert sched.attn_impl == "attention-free"
    for rid, (_, m) in enumerate(reqs):
        assert len(streams["cuda"][rid]) == m
        np.testing.assert_array_equal(streams["cuda"][rid],
                                      streams["blocked"][rid])


LSTM_TOL = {"float32": 1e-5,   # K <= 1024 fp32 FMAs summed in another order
            "bfloat16": 2e-2}  # c', h' rounded to bf16 on both sides


def _lstm_case(B, D, H, dtype, device, seed=0):
    """Operands of one LSTM step at lstm_init's weight scale, with a
    non-zero incoming state and bias."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dt,
                            device=device)

    return (t(D + H, 4 * H, scale=(D + H) ** -0.5), t(4 * H, scale=0.1),
            t(B, D), t(B, H), t(B, H, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,H", [
    (512, 512, 512),     # the dynamic_rnn phase of chip_smoke.py
    (1, 512, 512),       # one row
    (37, 20, 48),        # row, unit and K tails
    (32, 24, 48),        # NMT encoder
    (32, 72, 48),        # NMT decoder: x/h crossing inside a K tile
    (70, 0, 33),         # no input, odd units
    (1, 500, 300),       # one row; 50 K tiles over a cluster of 8
    (130, 36, 20),       # rows past one tile, units below one
    (3, 514, 262)])      # 4-byte copies (D % 4 == 2); 49 K tiles over 4
def test_lstm_cell_matches_plain_version(cuda_device, dtype, B, D, H):
    args = _lstm_case(B, D, H, dtype, cuda_device)
    before = lstm_kernel.lstm_cell.launches
    c, h = lstm_kernel.lstm_cell(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_cell.launches == before + 1
    c_ref, h_ref = lstm_cell_ref(*args)
    assert c.dtype == h.dtype == getattr(torch, dtype)
    for got, ref in ((c, c_ref), (h, h_ref)):
        torch.testing.assert_close(got.float(), ref.float(),
                                   rtol=LSTM_TOL[dtype],
                                   atol=LSTM_TOL[dtype])


@pytest.mark.cuda
def test_lstm_cell_refuses_autograd_and_bad_operands(cuda_device):
    w, b, x, c, h = _lstm_case(8, 16, 32, "float32", cuda_device)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="unfused"):
        lstm_kernel.lstm_cell(w, b, x, c, h)
    with torch.no_grad():
        lstm_kernel.lstm_cell(w, b, x, c, h)
    w = w.detach()
    with pytest.raises(TypeError):
        lstm_kernel.lstm_cell(w, b, x.bfloat16(), c, h)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_kernel.lstm_cell(w, b, x.t().contiguous().t(), c, h)
    with pytest.raises(ValueError, match="shapes"):
        lstm_kernel.lstm_cell(w[1:], b, x, c, h)


@pytest.mark.cuda
def test_dynamic_rnn_kernel_cell_equals_unfused_cell_on_card(cuda_device):
    """Inference through the fused cell: outputs and final state equal the
    unfused cell's, one launch per step up to max(lens)."""
    B, S, D, H = 64, 40, 96, 80
    params = bridge.init_lstm_params(D, H, seed=3, device=cuda_device)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.float32,
                     device=cuda_device)
    lens = torch.tensor(rng.integers(1, S - 5, B), device=cuda_device)
    fused = functools.partial(rnn.lstm_cell, kernel=lstm_ops.lstm_cell)
    with torch.no_grad():
        before = lstm_kernel.lstm_cell.launches
        out_k, (c_k, h_k) = rnn.dynamic_rnn(params, x, lens, hidden=H,
                                            cell=fused)
        assert lstm_kernel.lstm_cell.launches - before == int(lens.max())
        out, (c, h) = rnn.dynamic_rnn(params, x, lens, hidden=H)
    for got, ref in ((out_k, out), (c_k, c), (h_k, h)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_offload_gradients_equal_all_on_card(cuda_device):
    """Saved values swapped to pinned host memory and back give the same
    gradients as keeping them on the device, and they do go to the
    host."""
    B, S, D, H = 32, 24, 40, 48
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.float32,
                     device=cuda_device)
    lens = torch.tensor(rng.integers(1, S + 1, B), device=cuda_device)
    grads = {}
    for policy in ("all", "offload", "carry_offload"):
        params = bridge.init_lstm_params(D, H, seed=6, device=cuda_device)
        for p in params.values():
            p.requires_grad_()
        out, _ = rnn.dynamic_rnn(params, x, lens, hidden=H,
                                 save_policy=policy)
        stack = core.while_loop.last_stack
        assert (stack.host_bytes > 0) == (policy != "all")
        grads[policy] = torch.autograd.grad((out ** 2).mean(),
                                            [params["w"], params["b"]])
    for policy in ("offload", "carry_offload"):
        for got, ref in zip(grads[policy], grads["all"]):
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


def _fa_case(B, S, T, H, KV, D, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=gen).to(device, dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV,D", [
    (1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64), (1, 64, 64, 6, 3, 128),
    (2, 128, 128, 2, 1, 16), (1, 100, 137, 4, 2, 64), (2, 96, 70, 4, 1, 128),
    (2, 128, 128, 8, 2, 8), (1, 100, 137, 8, 2, 8),
    # the wgmma route's edges: S, T off multiples of 128 with B > 1 (TMA
    # zero-fills past T inside each batch row), T != S both ways, one
    # 128-row tile, D = 128 at G = 7
    (2, 200, 200, 8, 2, 64), (2, 130, 300, 8, 2, 64),
    (3, 300, 130, 28, 4, 128), (1, 128, 128, 4, 1, 64),
    (2, 256, 256, 14, 2, 128)])
def test_flash_attention_matches_plain_version(cuda_device, dtype, causal, B,
                                               S, T, H, KV, D):
    """The JAX sweep's shapes, the smoke llama's head dim 8, ragged S and
    T (top-left mask), and the wgmma route's edges.
    fp32 1e-5: the same fp32 math summed in another order over at most
    256 keys; bf16 rtol 2^-7, atol 2^-8 (module docstring)."""
    args = _fa_case(B, S, T, H, KV, D, getattr(torch, dtype), cuda_device)
    before = fa_kernel.flash_attention.launches
    out = fa_kernel.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (2**-7, 2**-8)
    torch.testing.assert_close(out.float(),
                               attention_ref(*args, causal=causal).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_attention_refuses_autograd_and_bad_operands(cuda_device):
    q, k, v = _fa_case(1, 128, 128, 4, 2, 64, torch.float32, cuda_device)
    before = fa_kernel.flash_attention.launches
    with pytest.raises(RuntimeError, match='attn_impl="gather"'):
        fa_kernel.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(TypeError):
        fa_kernel.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q[..., :48].contiguous(), k[..., :48]
                                  .contiguous(), v[..., :48].contiguous())
    assert fa_kernel.flash_attention.launches == before


@pytest.mark.cuda
def test_forward_flash_path_equals_chunked_path_on_card(cuda_device):
    """Mode full at S=128 under attn_impl="cuda" launches the kernel once
    per layer; fp32 logits match the chunked path's within 1e-4."""
    base = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                               compute_dtype="float32")
    params = bridge.init_params(base, seed=0, device="cuda")
    toks = torch.randint(0, base.vocab, (2, 128), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    logits = {}
    for impl in ("cuda", "gather"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        before = fa_kernel.flash_attention.launches
        with torch.no_grad():
            logits[impl], _ = model_zoo.forward(params, cfg, {"tokens": toks})
        launched = fa_kernel.flash_attention.launches - before
        assert launched == (base.n_layers if impl == "cuda" else 0)
    assert transformer.resolved_full_attn_impl(
        dataclasses.replace(base, attn_impl="cuda"), 128,
        "cuda") == "cuda-flash:sm_90a"
    torch.testing.assert_close(logits["cuda"], logits["gather"], rtol=1e-4,
                               atol=1e-4)
