"""The port's kernels against the JAX package's: the block-table
attention kernels and the selective scan; and the launch plans (the
decode kernel's split, the flash kernel's route and shared memory, the
LSTM cell's cluster split) and split arithmetic, which need no card.

On the CPU the port's wrappers run their plain PyTorch versions; they
are held to the JAX package's Pallas kernels (interpret mode, as its own
tests run them) and to its jnp oracles, on the same inputs made with
numpy. The CUDA kernels themselves are tested on the card by
``tests/test_torch_card.py``.

Tolerances: fp32 2e-5 (the JAX package's own kernel-vs-oracle bound:
the same fp32 math summed in another order); bf16 2e-2 (both sides
round an fp32 result to bf16, one ulp at magnitude 1 is 7.8e-3). The
selective scan is fp32 only: 1e-5 relative and absolute (the same
recurrence, its N-term dot products summed in another order).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_prefill.ops import flash_prefill as jax_fp
from repro.kernels.flash_prefill.ops import flash_prefill_ref as jax_fp_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_pa
from repro.kernels.paged_attention.ops import \
    paged_attention_ref as jax_pa_ref
from repro.kernels.selective_scan.ops import selective_scan as jax_ss
from repro.kernels.selective_scan.ops import \
    selective_scan_ref as jax_ss_ref
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.paged_attention.kernel import SPLIT, split_plan
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import (NEG_INF, gather_kv,
                                                     paged_attention_ref)
from repro_torch.kernels.selective_scan.ops import selective_scan

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, KV, hd, block, bpr): G = H / KV in {1, 3, 4, 7}
GEOMS = [(3, 4, 4, 16, 4, 5),
         (3, 6, 2, 16, 4, 4),
         (2, 8, 2, 32, 8, 3),
         (3, 7, 1, 16, 4, 5)]


def _case(kind, B, H, KV, hd, block, bpr, seed, C=5):
    """Shuffled table with -1 entries past each row's need; decode rows
    include cur_len 1 and a full row, prefill rows include a chunk that
    runs past the table's end."""
    rng = np.random.default_rng(seed)
    n_blocks = B * bpr + 3
    T = block * bpr
    kp = rng.standard_normal((n_blocks, block, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, block, KV, hd)).astype(np.float32)
    if kind == "decode":
        q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
        lens = rng.integers(1, T + 1, B)
        lens[0], lens[-1] = 1, T
        need = -(-lens // block)
    else:
        q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
        lens = rng.integers(0, T - C, B)
        lens[0], lens[-1] = 0, T - 2           # last row runs off the table
        need = -(-np.minimum(lens + C, T) // block)
    table = rng.permutation(n_blocks)[:B * bpr].reshape(B, bpr)
    table = np.where(np.arange(bpr)[None] < need[:, None], table, -1)
    return q, kp, vp, table.astype(np.int32), lens.astype(np.int32)


def _both(args, dtype):
    """(jax operands, torch operands) in ``dtype`` (both frameworks
    round the same fp32 values to bf16 the same way)."""
    q, kp, vp, table, lens = args
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    j = [jnp.asarray(a).astype(jd) for a in (q, kp, vp)] + \
        [jnp.asarray(table), jnp.asarray(lens)]
    t = [torch.from_numpy(a).to(td) for a in (q, kp, vp)] + \
        [torch.from_numpy(table), torch.from_numpy(lens)]
    return j, t


def _close(ours, theirs, dtype, rows=slice(None)):
    np.testing.assert_allclose(
        ours.float().numpy()[rows],
        np.asarray(theirs.astype(jnp.float32))[rows],
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"G{g[1] // g[2]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax(geom, dtype):
    j, t = _both(_case("decode", *geom, seed=1), dtype)
    ours = paged_attention(*t)
    _close(ours, jax_pa(*j), dtype)          # Pallas kernel, every row
    _close(ours, jax_pa_ref(*j), dtype)      # oracle (cur_len >= 1 here)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_zero_length_row(dtype):
    """cur_len == 0 (a free slot): the kernel contract is 0, which the
    JAX package's Pallas kernel also returns; its jnp oracle returns the
    mean of the masked lanes there, so the oracle is held on the other
    rows only."""
    args = list(_case("decode", *GEOMS[1], seed=2))
    args[4][1] = 0
    j, t = _both(args, dtype)
    ours = paged_attention(*t)
    assert torch.count_nonzero(ours[1]) == 0
    _close(ours, jax_pa(*j), dtype)
    keep = np.arange(len(args[4])) != 1
    _close(ours, jax_pa_ref(*j), dtype, rows=keep)


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"G{g[1] // g[2]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_matches_jax(geom, dtype):
    j, t = _both(_case("prefill", *geom, seed=3), dtype)
    ours = flash_prefill(*t)
    _close(ours, jax_fp(*j), dtype)
    _close(ours, jax_fp_ref(*j), dtype)


def test_flash_prefill_single_position_chunk_is_decode():
    """A one-token chunk at q_off = cur_len - 1 is exactly decode."""
    q, kp, vp, table, lens = [torch.from_numpy(a) for a in
                              _case("decode", *GEOMS[2], seed=4)]
    dec = paged_attention(q, kp, vp, table, lens)
    pre = flash_prefill(q, kp, vp, table, lens - 1)
    torch.testing.assert_close(pre, dec, rtol=1e-6, atol=1e-6)


def _dense_geometries():
    """(arch, H, KV, hd) of every dense config of the port: the attention
    shapes the decode kernel serves (``chip_smoke.py`` checks it on the
    card at the same four)."""
    cfgs = [(arch, get_config(arch)) for arch in ARCH_IDS]
    return [(arch, c.n_heads, c.n_kv_heads, c.resolved_head_dim)
            for arch, c in cfgs if c.family == "dense"]


def _partitions(plan, width):
    """[start, stop) of each partition, as the kernel derives them from
    the plan: partition s starts at s * split and holds at most split
    positions below the table's width."""
    return [(s * plan.split, min((s + 1) * plan.split, width))
            for s in range(plan.n_splits)]


@pytest.mark.parametrize("geom", _dense_geometries(), ids=lambda g: g[0])
@pytest.mark.parametrize("block", [4, 8, 16, 32])
@pytest.mark.parametrize("max_len", [577, 2048])
def test_split_plan_covers_every_position_once(geom, block, max_len):
    """The decode kernel's launch plan: partitions of at most SPLIT
    positions tile [0, bpr * block) exactly once, the row tiles cover G
    with no CTA left without a real row, and the scratch holds one
    (acc, m, l) partial per (row, query head, partition)."""
    _, H, KV, hd = geom
    B, G, bpr = 8, H // KV, -(-max_len // block)
    plan = split_plan(B, KV, G, bpr, block, hd)
    seen = np.zeros(bpr * block, np.int64)
    for lo, hi in _partitions(plan, bpr * block):
        assert 0 < hi - lo <= SPLIT == plan.split
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.n_splits == -(-bpr * block // SPLIT)
    assert plan.rows in (1, 2, 4, 8) and plan.rows >= min(G, 8)
    assert plan.rows * (plan.row_tiles - 1) < G <= plan.rows * plan.row_tiles
    assert plan.grid == (B, KV, plan.n_splits * plan.row_tiles)
    assert plan.scratch == (B * H * plan.n_splits * (hd + 2),)


@pytest.mark.parametrize("H,KV,m", [(14, 2, 7), (8, 2, 4), (32, 8, 2),
                                    (32, 8, 4)])
def test_split_plan_for_a_head_range(H, KV, m):
    """A rank's H/m query heads from ``q_head0`` (a serving mesh's model
    axis splitting the query heads and not the K/V heads): the grid walks
    exactly the K/V heads the range touches, the row tiles cover the most
    query heads any of them has in the range, and the scratch holds one
    partial per (row, local head, partition)."""
    B, hd, bpr, block = 8, 64, 37, 16
    G, n = H // KV, H // m
    for r in range(m):
        q0 = r * n
        plan = split_plan(B, KV, G, bpr, block, hd, n, q0)
        touched = sorted({(q0 + j) // G for j in range(n)})
        most = max(sum((q0 + j) // G == h for j in range(n))
                   for h in touched)
        assert plan.grid[:2] == (B, len(touched))
        assert plan.rows * plan.row_tiles >= most
        assert plan.rows * (plan.row_tiles - 1) < min(G, n)
        assert plan.scratch == (B * n * plan.n_splits * (hd + 2),)
    assert split_plan(B, KV, G, bpr, block, hd, H, 0) == \
        split_plan(B, KV, G, bpr, block, hd)


def _partitioned_decode(q, kp, vp, table, lens, plan):
    """Decode as the split kernel computes it, in plain fp32: per
    partition of the plan a partial (m, l, unnormalised acc) over the
    positions below cur_len (an empty one: m = -1e30, l = 0, acc = 0),
    then out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the
    partials with l_s > 0."""
    B, _, H, hd = q.shape
    KV = kp.shape[2]
    kg, vg = gather_kv(kp, vp, table)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qf, kg.float())
    out = torch.zeros(B, KV, H // KV, hd)
    for b in range(B):
        ms, ls, accs = [], [], []
        for lo, hi in _partitions(plan, table.shape[1] * kp.shape[1]):
            hi = min(hi, int(lens[b]))
            if hi <= lo:
                ms.append(torch.full(s.shape[1:3], NEG_INF))
                ls.append(torch.zeros(s.shape[1:3]))
                accs.append(torch.zeros(s.shape[1:3] + (hd,)))
                continue
            sb = s[b, :, :, lo:hi]
            m = sb.amax(-1)
            p = torch.exp(sb - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgt,tkd->kgd", p, vg[b, lo:hi].float()))
        m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        M = torch.where(l > 0, m, NEG_INF).amax(0)
        w = torch.where(l > 0, torch.exp(m - M), 0.0)
        out[b] = (w[..., None] * acc).sum(0) / torch.clamp(
            (w * l).sum(0), min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd)


@pytest.mark.parametrize("block", [4, 8, 16, 32])
def test_split_decode_arithmetic_equals_plain(block):
    """The partials and their combine, through the plan's boundaries,
    equal ``paged_attention_ref`` in fp32 (2e-5) with cur_len on the
    split edges (0, 1, P - 1, P, P + 1) and at the table's width, and the
    cur_len == 0 row is exactly 0."""
    rng = np.random.default_rng(20 + block)
    H, KV, hd, bpr = 8, 2, 16, -(-160 // block)
    width = bpr * block
    lens = np.array([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, width], np.int32)
    B, n_blocks = len(lens), len(lens) * bpr + 3
    need = -(-lens // block)
    table = rng.permutation(n_blocks)[:B * bpr].reshape(B, bpr)
    table = np.where(np.arange(bpr)[None] < need[:, None], table, -1)
    q, kp, vp = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
                 for shape in ((B, 1, H, hd), (n_blocks, block, KV, hd),
                               (n_blocks, block, KV, hd)))
    table = torch.tensor(table, dtype=torch.int32)
    cur = torch.tensor(lens)
    plan = split_plan(B, KV, H // KV, bpr, block, hd)
    ours = _partitioned_decode(q, kp, vp, table, cur, plan)
    ref = paged_attention_ref(q, kp, vp, table, cur)
    torch.testing.assert_close(ours, ref, rtol=2e-5, atol=2e-5)
    assert torch.count_nonzero(ours[0]) == 0


def _scan_case(B, Q, Di, N, seed):
    """One selective-scan chunk as mamba1_forward feeds it: softplus'd
    steps, A = -exp(A_log) and a non-zero incoming state."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, Q, Di)) - 1.0))
    A = -np.exp(0.5 * rng.standard_normal((Di, N)))
    arrays = (dt, A, rng.standard_normal((B, Q, N)),
              rng.standard_normal((B, Q, N)),
              rng.standard_normal((B, Q, Di)),
              rng.standard_normal((B, Di, N)))
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("Q", [8, 13])
def test_selective_scan_matches_jax(B, Q, N):
    args = _scan_case(B, Q, 64, N, seed=10 * Q + N + B)
    y, h = selective_scan(*[torch.from_numpy(a) for a in args])
    assert y.dtype == h.dtype == torch.float32
    for ref in (jax_ss(*[jnp.asarray(a) for a in args]),   # Pallas
                jax_ss_ref(*[jnp.asarray(a) for a in args])):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-5)


def test_selective_scan_carries_state_across_chunks():
    """Two chunks with the state carried equal one chunk of both."""
    args = _scan_case(2, 12, 16, 8, seed=7)
    t = [torch.from_numpy(a) for a in args]
    dt, A, B_, C_, x, h0 = t
    y, h = selective_scan(*t)
    y1, h1 = selective_scan(dt[:, :5].contiguous(), A, B_[:, :5].contiguous(),
                            C_[:, :5].contiguous(), x[:, :5].contiguous(), h0)
    y2, h2 = selective_scan(dt[:, 5:].contiguous(), A, B_[:, 5:].contiguous(),
                            C_[:, 5:].contiguous(), x[:, 5:].contiguous(), h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).family == "dense"])
@pytest.mark.parametrize("smoke", [False, True])
def test_flash_route_for_every_config_head_dim(arch, smoke):
    """Full-width head dims take the wgmma route in bf16, the smoke
    widths mma.sync, fp32 the fp32 pipes; every head dim is one the
    kernel takes (a wgmma CTA's shared memory is held to the block limit
    by a static_assert in csrc/flash_attention.cu)."""
    D = get_config(arch, smoke=smoke).head_dim
    assert D in fa_kernel.HEAD_DIMS
    assert fa_kernel.route(D, torch.bfloat16) == ("mma.sync" if smoke
                                                  else "wgmma")
    assert fa_kernel.route(D, torch.float32) == "fp32"


@pytest.mark.parametrize("B,D,H", [
    (512, 512, 512), (1, 512, 512), (37, 20, 48), (32, 24, 48),
    (32, 72, 48), (70, 0, 33), (1, 500, 300), (130, 36, 20),
    (3, 514, 262), (4096, 1024, 1024), (2, 3, 1)])
def test_lstm_launch_plan_covers_k_once(B, D, H):
    """The fp32 LSTM cell's launch plan: the cluster's K ranges tile
    [0, D + H) exactly once in whole K tiles, the split is a legal
    cluster size that keeps each CTA a pipeline's depth of tiles (or is
    1), and the grid covers every row and unit. (Its shared memory is
    held to the block limit by a static_assert in csrc/lstm_cell.cu.)"""
    plan = lstm_kernel.launch_plan(B, D, H)
    K = D + H
    assert plan.split in lstm_kernel.SPLITS
    assert plan.k_per_split % lstm_kernel.K_TILE == 0
    seen = np.zeros(K, np.int64)
    for r in range(plan.split):
        seen[r * plan.k_per_split:min(K, (r + 1) * plan.k_per_split)] += 1
    assert (seen == 1).all()
    assert (plan.split - 1) * plan.k_per_split < K
    k_tiles = -(-K // lstm_kernel.K_TILE)
    assert plan.split == 1 or \
        plan.k_per_split // lstm_kernel.K_TILE >= lstm_kernel.STAGES
    assert plan.k_per_split // lstm_kernel.K_TILE <= k_tiles
    ux, ry, sz = plan.grid
    assert sz == plan.split
    assert (ux - 1) * lstm_kernel.UNITS < H <= ux * lstm_kernel.UNITS
    assert (ry - 1) * lstm_kernel.ROWS < B <= ry * lstm_kernel.ROWS
    assert lstm_kernel.ROWS % plan.split == 0   # rows of the gate epilogue


def test_lstm_launch_plan_fills_the_card_at_the_rnn_step():
    """At the dynamic_rnn step (B=512, D=H=512) the 64 tiles take a
    cluster of 2: 128 CTAs, one wave on 132 SMs."""
    plan = lstm_kernel.launch_plan(512, 512, 512)
    assert plan.split == 2 and plan.grid == (16, 4, 2)
