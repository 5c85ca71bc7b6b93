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
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,m", [(14, 2, 7), (8, 2, 4), (32, 8, 2)])
def test_kernel_takes_a_head_range(cuda_device, kind, dtype, H, KV, m):
    """A rank's query heads on a serving mesh whose model axis splits
    them and not the K/V heads: at every ``q_head0`` of H heads split m
    ways (internvl2-1b's 14/2 over 7 ranks: two heads a rank, ranges that
    straddle the two K/V heads; G = 4 over 4; G = 4 over 2) the kernel on
    the rank's heads equals its plain version there, and that equals the
    whole call's heads; with ``q_head0 = 0`` and the whole count the
    call is the plain one."""
    C = 5 if kind == "verify" else 40
    args = _case("decode" if kind == "decode" else "prefill", 6, H, KV, 64,
                 16, 10, C, dtype, cuda_device, seed=H + m)
    kern, plain = {"decode": (pa_kernel.paged_attention,
                              paged_attention_ref),
                   "prefill": (fp_kernel.flash_prefill, flash_prefill_ref),
                   "verify": (fp_kernel.flash_verify,
                              flash_prefill_ref)}[kind]
    q, rest = args[0], args[1:]
    whole = plain(q, *rest)
    torch.testing.assert_close(kern(q, *rest, 0, H).float(), whole.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    n = H // m
    for r in range(m):
        ql = q[:, :, r * n:(r + 1) * n].contiguous()
        before = kern.launches
        out = kern(ql, *rest, q_head0=r * n, n_heads=H)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        ref = plain(ql, *rest, q_head0=r * n, n_heads=H)
        torch.testing.assert_close(ref.float(),
                                   whole[:, :, r * n:(r + 1) * n].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


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


def _aliased_case(kind, dtype, block, device, seed=0):
    """A block table whose rows alias blocks, as the prefix cache leaves
    it: rows 0-3 share a 5-block prefix (row 0 owns it), rows 4-5 a
    3-block one, row 6 maps one shared block and row 7 none; each row's
    private blocks follow. Decode reads each row to a length past its
    shared prefix; the chunk starts at the row's first unshared position
    (``q_off = hits x block``), as a prefix hit's prefill does."""
    rng = np.random.default_rng(seed)
    B, H, KV, hd, bpr, C = 8, 32, 8, 64, 256 // block, 40
    hits = np.array([5, 5, 5, 5, 3, 3, 1, 0])
    n_blocks = B * bpr + 3
    ids = iter(rng.permutation(n_blocks))
    prefix = {5: [next(ids) for _ in range(5)], 3: [next(ids) for _ in
                                                    range(3)],
              1: [next(ids)], 0: []}
    table = np.full((B, bpr), -1, np.int64)
    if kind == "decode":
        lens = hits * block + rng.integers(1, 3 * block, B)
        need = -(-lens // block)
        q = rng.standard_normal((B, 1, H, hd))
    else:
        lens = hits * block
        need = -(-(lens + C) // block)
        q = rng.standard_normal((B, C, H, hd))
    for b in range(B):
        row = prefix[hits[b]] + [next(ids) for _ in range(need[b] - hits[b])]
        table[b, :len(row)] = row
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
@pytest.mark.parametrize("block", [16, 8])
def test_block_table_kernels_over_aliased_tables(cuda_device, kind, dtype,
                                                 block):
    """Both block-table kernels read blocks that several rows' tables
    map (the prefix cache's sharing) as their plain versions do."""
    args = _aliased_case(kind, dtype, block, cuda_device)
    kern, plain = ((pa_kernel.paged_attention, paged_attention_ref)
                   if kind == "decode"
                   else (fp_kernel.flash_prefill, flash_prefill_ref))
    out = kern(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_copy_on_write_on_card_equals_cpu(cuda_device):
    """alloc with shared blocks and pins, a sharer's copy-on-write, a
    dry pool, release and free: on the card the tables, refcounts,
    owners and pools equal the same calls' on the CPU."""
    caches = {}
    for dev in ("cpu", cuda_device):
        c = kvc.PagedKVCache.create(2, 3, 12, 2, 64, torch.float32, dev,
                                    block=4, n_blocks=7, sharing=True)
        g = torch.Generator().manual_seed(0)
        c.k_pool.copy_(torch.randn(c.k_pool.shape, generator=g))
        c.v_pool.copy_(-c.k_pool)

        def t(a):
            return torch.tensor(a, dtype=torch.int32, device=dev)
        pin = torch.zeros((1, 3), dtype=torch.bool, device=dev)
        pin[0, :2] = True
        c.alloc(t([0]), t([12]), pin=pin)
        shared = torch.full((2, 3), -1, dtype=torch.int32, device=dev)
        shared[:, :2] = c.table[0, :2]
        c.alloc(t([1, 2]), t([12, 8]), shared=shared)
        c.ensure_private(t([1, 2]), start=t([2, 5]), width=4)
        c.release(c.table[0, :1].clone())
        c.free(t([0]))
        caches[str(dev)] = c
    a, b = caches["cpu"], caches[str(cuda_device)]
    for x in ("table", "refcount", "owner", "k_pool", "v_pool"):
        assert torch.equal(getattr(a, x), getattr(b, x).cpu()), x


def _prefix_requests(cfg, rng):
    """Prompts with a shared 32-token system prefix and distinct tails,
    and whole repeats."""
    system = rng.integers(2, cfg.vocab, 32)
    tails = [rng.integers(2, cfg.vocab, n) for n in (9, 16, 5)]
    ps = [np.concatenate([system, t]) for t in tails]
    ps += [ps[0], ps[1], ps[0]]
    return [(p[None].astype(np.int32), m)
            for p, m in zip(ps, (9, 12, 5, 8, 10, 7))]


@pytest.mark.cuda
def test_prefix_cache_graph_segment_on_card(cuda_device):
    """A smoke model (hd 64) through the chunked paged scheduler with the
    prefix cache on the card in fp32: graph segments give the host-read
    segments' streams and the cache-off run's, with the same hits; both
    block-table kernels launch (counted on the device in the graph) and
    nothing gathers; after the drain the device's free count is the host
    mirror's."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", head_dim=64,
                              n_heads=8, n_kv_heads=2, d_model=128,
                              attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    reqs = _prefix_requests(cfg, np.random.default_rng(3))
    runs = {}
    for name, loop, pfx in (("graph", "graph", True), ("host", "host", True),
                            ("off", "graph", False)):
        sched = sched_lib.DecodeScheduler(
            params, cfg, n_slots=2, prompt_len=48, max_new_cap=12,
            eos_id=-1, kv="paged", kv_block=16, prefill="chunked",
            chunk_tokens=16, loop=loop, prefix_cache=pfx)
        sched.warmup()
        c0 = (pa_kernel.paged_attention.launches,
              fp_kernel.flash_prefill.launches, kvc.PagedView.gather_calls)
        for rid, (p, m) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid)
        streams = {f.request_id: f.tokens for f in sched.run_until_drained()}
        torch.cuda.synchronize()
        c1 = (pa_kernel.paged_attention.launches,
              fp_kernel.flash_prefill.launches, kvc.PagedView.gather_calls)
        runs[name] = (streams, sched.prefix_hit_blocks,
                      [b - a for a, b in zip(c0, c1)])
        assert sched.free_blocks == int(
            sched.pool.cache["attn"].free_count)
        sched.close()
    g, h, off = runs["graph"], runs["host"], runs["off"]
    assert g[1] == h[1] > 0 and off[1] == 0
    assert g[2] == h[2] and min(g[2][:2]) > 0 and g[2][2] == 0
    for rid, (_, m) in enumerate(reqs):
        assert len(g[0][rid]) == m
        np.testing.assert_array_equal(g[0][rid], h[0][rid])
        np.testing.assert_array_equal(g[0][rid], off[0][rid])


@pytest.mark.cuda
def test_graph_segment_stepped_from_a_worker_thread_on_card(cuda_device):
    """The segment captured on the main thread replays from a worker
    thread (the streaming front-end's driver) on the scheduler's own
    stream: the streams equal the main thread's run."""
    import asyncio
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", head_dim=64,
                              n_heads=8, n_kv_heads=2, d_model=128,
                              attn_impl="cuda")
    params = bridge.init_params(cfg, seed=0, device=cuda_device)
    reqs = _prefix_requests(cfg, np.random.default_rng(4))

    def make():
        s = sched_lib.DecodeScheduler(
            params, cfg, n_slots=2, prompt_len=48, max_new_cap=12,
            eos_id=-1, kv="paged", kv_block=16, prefill="chunked",
            chunk_tokens=16, prefix_cache=True)
        s.warmup()
        for rid, (p, m) in enumerate(reqs):
            s.submit(p, max_new=m, request_id=rid)
        return s

    main = make()
    want = {f.request_id: f.tokens for f in main.run_until_drained()}
    main.close()
    sched = make()

    async def drive():
        out = {}
        while sched.pending:
            for f in await asyncio.to_thread(sched.step, True, 4):
                out[f.request_id] = f.tokens
        return out

    got = asyncio.run(drive())
    torch.cuda.synchronize()
    assert sched.loop_impl == "cuda-graph:while" and sched.graph_replays > 0
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    sched.close()


@pytest.mark.cuda
def test_copy_on_write_inside_a_captured_loop_on_card(cuda_device):
    """In a body that ``DeviceLoop`` captures, ``ensure_private`` puts the
    copy behind an IF node on ``any(needs)``: the first replay copies the
    shared blocks (as the eager branchless form does on the CPU), the
    second finds nothing to copy and changes nothing."""
    from repro_torch.core import device_loop

    def build(dev):
        c = kvc.PagedKVCache.create(2, 3, 12, 2, 64, torch.float32, dev,
                                    block=4, n_blocks=9, sharing=True)
        g = torch.Generator().manual_seed(1)
        c.k_pool.copy_(torch.randn(c.k_pool.shape, generator=g))
        c.v_pool.copy_(-c.k_pool)
        t = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
        pin = torch.zeros((1, 3), dtype=torch.bool, device=dev)
        pin[0, :2] = True
        c.alloc(t([0]), t([12]), pin=pin)
        shared = torch.full((2, 3), -1, dtype=torch.int32, device=dev)
        shared[:, :2] = c.table[0, :2]
        c.alloc(t([1, 2]), t([12, 8]), shared=shared)
        return c, t([1, 2]), t([2, 5])

    cpu, rows, start = build("cpu")
    cpu.ensure_private(rows, start=start, width=4)
    card, rows, start = build(cuda_device)
    carry = torch.zeros((), dtype=torch.int32, device=cuda_device)

    def body(c):
        card.ensure_private(rows, start=start, width=4)
        return c

    with torch.no_grad():           # capture runs no kernel
        loop = device_loop.DeviceLoop(None, body, carry, max_iters=1)
    loop.run()
    torch.cuda.synchronize()
    for x in ("table", "refcount", "owner", "k_pool", "v_pool"):
        assert torch.equal(getattr(cpu, x), getattr(card, x).cpu()), x
    after = [getattr(card, x).clone() for x in ("table", "refcount",
                                                 "k_pool")]
    loop.run()
    torch.cuda.synchronize()
    for x, v in zip(("table", "refcount", "k_pool"), after):
        assert torch.equal(getattr(card, x), v), x
    loop.close()


@pytest.mark.cuda
def test_audio_graph_segment_equals_host_read_on_card(cuda_device):
    """The audio family (whisper-small's smoke config widened to heads of
    64, the kernel's head dims; fp32) through one-shot admission: the
    kernel path in a graph segment, in host-read segments and the gather
    path give one set of streams; the device-counted paged-attention
    launches equal the Python-counted ones, one a decoder layer a decode
    iteration, and the self cache is never gathered."""
    cfg = dataclasses.replace(get_config("whisper-small", smoke=True),
                              d_model=256, head_dim=64,
                              compute_dtype="float32")
    params = bridge.init_params(cfg, seed=2, device=cuda_device)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(2, cfg.vocab, (1, n)).astype(np.int32), m,
             rng.standard_normal((1, cfg.n_frames, cfg.d_model)).astype(
                 np.float32)) for n, m in ((5, 6), (12, 4), (3, 7), (9, 5))]
    runs = {}
    for name, impl, loop in (("graph", "cuda", "graph"),
                             ("host", "cuda", "host"),
                             ("gather", "gather", "host")):
        sched = sched_lib.DecodeScheduler(
            params, dataclasses.replace(cfg, attn_impl=impl), n_slots=2,
            prompt_len=12, max_new_cap=8, eos_id=-1, kv="paged",
            kv_block=8, loop=loop)
        sched.warmup()
        pa_kernel.paged_attention.launches = 0
        kvc.PagedView.gather_calls = 0
        for rid, (p, m, f) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid, frames=f)
        got = {r.request_id: r.tokens for r in sched.run_until_drained()}
        runs[name] = (got, pa_kernel.paged_attention.launches,
                      kvc.PagedView.gather_calls, int(sched._counts[3]))
        sched.close()
    assert runs["graph"][1] == runs["host"][1] == \
        cfg.n_layers * runs["graph"][3] > 0
    assert runs["graph"][2] == runs["host"][2] == 0
    for name in ("host", "gather"):
        for rid in range(len(reqs)):
            np.testing.assert_array_equal(runs[name][0][rid],
                                          runs["graph"][0][rid])


# -------------------------------------------------- the graph gradient loop
#
# ``dynamic_rnn(impl="graph")``: the forward and §5.1's gradient loop as
# two CUDA-graph WHILE nodes (``core.device_grad``), held to the host
# lowering on the card. The graph replays the host's kernels on the same
# operands (cuBLAS may pick another algorithm under capture), so values
# and gradients are held to rtol 1e-5, atol 1e-6.

def _rnn_graph_case(device, B=16, S=12, D=24, H=32, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    params = rnn.lstm_init(gen, D, H)
    x = torch.randn(B, S, D, generator=gen, device=device)
    lens = torch.randint(3, S + 1, (B,), generator=gen, device=device)
    return params, x, lens, H


def _rnn_grads(params, x, lens, H, policy, impl):
    leaves = [params["w"].detach().clone().requires_grad_(),
              params["b"].detach().clone().requires_grad_(),
              x.detach().clone().requires_grad_()]
    out, (c, h) = rnn.dynamic_rnn({"w": leaves[0], "b": leaves[1]},
                                  leaves[2], lens, hidden=H,
                                  save_policy=policy, impl=impl)
    loss = (out ** 2).mean() + (c * h).sum()
    return (out.detach(), *torch.autograd.grad(loss, leaves))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["all", "offload", "carry",
                                    "carry_offload"])
@pytest.mark.parametrize("with_lens", [False, True])
def test_dynamic_rnn_graph_grads_equal_host_on_card(cuda_device, policy,
                                                    with_lens):
    from repro_torch.core import device_grad
    from repro_torch.core.device_grad import GradLoop
    params, x, lens, H = _rnn_graph_case(cuda_device)
    lens = lens if with_lens else None
    ref = _rnn_grads(params, x, lens, H, policy, "host")
    cap0, rep0 = GradLoop.captures, GradLoop.replays
    reads0 = core.while_loop.host_reads
    for _ in range(2):
        ours = _rnn_grads(params, x, lens, H, policy, "graph")
        torch.cuda.synchronize()
        for a, b in zip(ours, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert GradLoop.captures - cap0 == 1
    assert GradLoop.replays - rep0 == 4
    assert core.while_loop.host_reads == reads0
    loop = core.while_loop.last_grad_loop
    pushed = loop.residual_bytes if policy in ("all", "offload") else \
        loop.carry_bytes
    assert pushed > 0
    assert loop.host_bytes == (12 * pushed if policy.endswith("offload")
                               else 0)
    device_grad.release()


@pytest.mark.cuda
def test_dynamic_rnn_graph_inference_through_the_fused_cell_on_card(
        cuda_device):
    from repro_torch.core import device_grad
    params, x, lens, H = _rnn_graph_case(cuda_device, B=32, D=72, H=48)
    fused = functools.partial(rnn.lstm_cell, kernel=lstm_ops.lstm_cell)
    with torch.no_grad():
        ref = rnn.dynamic_rnn(params, x, lens, hidden=H, cell=fused)
        out = rnn.dynamic_rnn(params, x, lens, hidden=H, cell=fused,
                              impl="graph")
    assert core.while_loop.last_grad_loop.iterations() == int(lens.max())
    for a, b in zip((out[0], *out[1]), (ref[0], *ref[1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    device_grad.release()


@pytest.mark.cuda
def test_carry_stack_in_pinned_memory_on_card(cuda_device):
    from repro_torch.core.stacks import CarryStack
    like = torch.zeros(3, 5, device=cuda_device)
    st = CarryStack(like, 4, offload=True)
    assert st.buf.is_pinned() and st.host_bytes == 4 * 60
    for k in range(4):
        st.push(torch.tensor(k, device=cuda_device),
                torch.full((3, 5), float(k), device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(st.buf[:, 1, 2], torch.arange(4.0))
    got = st.pop(torch.tensor(2, device=cuda_device)).clone()
    assert torch.equal(got, torch.full((3, 5), 2.0, device=cuda_device))
