"""Mixture-of-Experts layer: the paper's own motivating architecture
(Fig. 1: RNN layers dynamically connected through an MoE), whose
routing is data-dependent control flow.

Port of ``repro/models/moe.py`` (``moe_params``, ``_group_capacity``,
``moe_mlp`` and its gather pair). GShard-style grouping with sort-based
capacity, on integer tensors only:

- one **group** a sequence (dim B); decode (S == 1, B > 1) regroups the
  batch into ONE group of B tokens, as the JAX package does, so a
  decode row's routing depends on what the other rows feed;
- within a group the routed entries are stably argsorted by expert id,
  positioned within the capacity ``C`` by a first-occurrence offset
  (``searchsorted``), and scattered into ``E * (C + 1)`` slot maps
  (slot ``C`` of each expert is its drop row). Several overflow entries
  scatter into one drop row, and the order of duplicate scatters is
  unspecified in both frameworks; clearing the drop rows to the
  sentinel after the scatter is what makes the maps deterministic;
- dispatch and combine are gathers whose backward is again a gather
  (``_DispatchGather``, ``_CombineGather``), not autograd's
  scatter-add: every kept slot holds exactly one routed entry;
- the per-expert SwiGLU is a dense product with E as a batch dim over
  every expert's ``C`` rows (``torch.einsum``, as the JAX package's
  einsum: plain matrix products, no kernel of their own).

Everything is capturable in a CUDA graph: ``C`` is a Python int from
the static group length, and no op reads the device or sizes an output
by data.

On a mesh in training (DTensor inputs) the layout is the JAX package's
``(BATCH, EXPERT, None, None)`` constraint on the dispatch buffer and
the expert output: the groups split over the data axes only and are
replicated over ``model``; each model rank routes its own groups (the
same integer maps as off the mesh) and holds only its slice of the
expert pool (``sharding.split_rows``). Where ``EXPERT`` binds to
``model`` that is its E/m experts' rows: it dispatches to, runs and
combines only their slots, and an entry routed to another rank's
expert reads a zero row. Where ``EXPERT_MLP`` binds instead (the pool
does not divide), it is its F/m columns of every expert's hidden width
(``w_down``'s matching rows), over every slot. Either way a rank's
output is a partial sum, and one all-reduce over ``model`` completes
it (its backward, the rows' cotangents, likewise); the weights'
gradients stay split. With neither bound the pool is replicated and
the groups split over ``model`` too.

Serving on a mesh's model axis runs on plain tensors, each rank on its
slices of the weights (``sharding.serve_slices``): every rank routes
every group (the decode's one batch-wide group included) with the same
integer maps, so capacity and drops are the one-rank run's, and runs
``experts`` on its experts' rows or hidden columns as above; the
experts' part and the shared experts' part (their ``MLP`` columns) are
summed over the axis in one all-reduce.

``torch.topk`` does not promise JAX's lower-index-first order on tied
router probabilities. Parity runs in fp32, where exact ties in a
softmax of random projections do not occur in practice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..dist import sharding as sh
from . import layers


def moe_params(b, cfg, d_model: int):
    m = cfg.moe
    p = {"router": b.p((d_model, m.n_experts), (sh.EMBED, None), scale=0.1),
         "w_gate": b.p((m.n_experts, d_model, m.d_ff_expert),
                       (sh.EXPERT, sh.EMBED, sh.EXPERT_MLP), fan_in=d_model),
         "w_up": b.p((m.n_experts, d_model, m.d_ff_expert),
                     (sh.EXPERT, sh.EMBED, sh.EXPERT_MLP), fan_in=d_model),
         "w_down": b.p((m.n_experts, m.d_ff_expert, d_model),
                       (sh.EXPERT, sh.EXPERT_MLP, sh.EMBED),
                       fan_in=m.d_ff_expert)}
    if m.n_shared_experts:
        p["shared_gate"] = b.p((d_model, m.d_ff_shared), (sh.EMBED, sh.MLP))
        p["shared_up"] = b.p((d_model, m.d_ff_shared), (sh.EMBED, sh.MLP))
        p["shared_down"] = b.p((m.d_ff_shared, d_model), (sh.MLP, sh.EMBED))
    return p


def _take_rows(src, idx):
    """out[g, j] = src[g, idx[g, j]] for src (G, N, D), idx (G, M)."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


class _DispatchGather(torch.autograd.Function):
    """buf[g, slot] = xg_pad[g, slot_token[g, slot]]. Backward is a
    gather: g_x[t] = sum_k (1 - dropped[t, k]) * g_buf[token_slot[t, k]]
    (every kept slot holds exactly one token)."""

    @staticmethod
    def forward(ctx, xg_pad, slot_token, token_slot, dropped):
        ctx.save_for_backward(token_slot, dropped)
        return _take_rows(xg_pad, slot_token)

    @staticmethod
    def backward(ctx, g):
        token_slot, dropped = ctx.saved_tensors
        G, S, K = token_slot.shape
        picked = _take_rows(g, token_slot.reshape(G, S * K))
        picked = picked.reshape(G, S, K, -1).masked_fill(dropped[..., None],
                                                         0.0)
        g_x = picked.sum(dim=2)
        return (torch.cat([g_x, g_x.new_zeros(G, 1, g_x.shape[-1])], 1),
                None, None, None)


class _CombineGather(torch.autograd.Function):
    """contrib[g, s, k] = h_flat[g, token_slot[g, s, k]]. Backward:
    g_h[slot] = g_contrib[slot_entry[slot]] (empty slots read the zero
    row through the S * K sentinel)."""

    @staticmethod
    def forward(ctx, h_flat, token_slot, slot_entry):
        ctx.save_for_backward(slot_entry)
        G, S, K = token_slot.shape
        out = _take_rows(h_flat, token_slot.reshape(G, S * K))
        return out.reshape(G, S, K, h_flat.shape[-1])

    @staticmethod
    def backward(ctx, g):
        (slot_entry,) = ctx.saved_tensors
        G, S, K, D = g.shape
        g_flat = g.reshape(G, S * K, D)
        g_pad = torch.cat([g_flat, g_flat.new_zeros(G, 1, D)], 1)
        return _take_rows(g_pad, slot_entry), None, None


def expert_swiglu(be, w_gate, w_up, w_down):
    """The dense per-expert SwiGLU over every expert's ``C`` rows, E a
    batch dim: be (G, E, C, D) -> (G, E, C, D). Under a split of the
    hidden width each rank's result is its part of the sum over F."""
    g = F.silu(torch.einsum("gecd,edf->gecf", be, w_gate))
    u = torch.einsum("gecd,edf->gecf", be, w_up)
    return torch.einsum("gecf,efd->gecd", g * u, w_down)


def _group_capacity(group_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(group_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(expert_idx, E: int, C: int):
    """Sort-based capacity routing of every group at once.

    expert_idx: (G, S, K) int. Returns ``(slot_token, slot_entry,
    token_slot, dropped)``: slot -> source token (sentinel S), slot ->
    routed entry ``s * K + k`` (sentinel S * K), each of shape (G, E *
    (C + 1)); token -> its K slots (G, S, K); and which routed entries
    landed in a drop row (G, S, K) bool."""
    G, S, K = expert_idx.shape
    N, dev = S * K, expert_idx.device
    flat_e = expert_idx.reshape(G, N)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order).contiguous()
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(N, device=dev) - group_start
    dest_c = torch.where(pos_in_e < C, pos_in_e, C)
    slot = sorted_e * (C + 1) + dest_c
    slot_token = torch.full((G, E * (C + 1)), S, dtype=torch.long,
                            device=dev).scatter_(1, slot, order // K)
    slot_entry = torch.full((G, E * (C + 1)), N, dtype=torch.long,
                            device=dev).scatter_(1, slot, order)
    # drop rows are cleared: they hold NO token (zeros flow), whichever
    # duplicate scatter landed last
    drop_rows = torch.arange(E, device=dev) * (C + 1) + C
    slot_token.index_fill_(1, drop_rows, S)
    slot_entry.index_fill_(1, drop_rows, N)
    pos_orig = torch.zeros_like(flat_e).scatter_(1, order, dest_c)
    token_slot = (flat_e * (C + 1) + pos_orig).reshape(G, S, K)
    return slot_token, slot_entry, token_slot, \
        (token_slot % (C + 1)) == C


def moe_mlp(p: Dict, x, cfg, *, need_aux: bool = True, split=sh.WHOLE
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out, aux). Groups are sequences (dim B); decode
    (S == 1, B > 1) is ONE batch-wide group. ``aux`` holds
    ``moe_load_balance`` (Switch-style) and ``moe_z_loss`` (router
    z-loss), or nothing when ``need_aux`` is False (serving). ``split``:
    the weights are a rank's slices on a serving mesh's model axis
    (module docstring)."""
    m = cfg.moe
    B0, S0, D0 = x.shape
    regrouped = S0 == 1 and B0 > 1
    if regrouped:
        x = x.reshape(1, B0, D0)
    G, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = _group_capacity(S, cfg)
    cdt = cfg.dtype("compute")

    xg = x.to(cdt)
    logits = sh.keep_grad_layout(xg.float() @ p["router"].float())  # G,S,E
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, K, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    def experts(split, xg, gate, expert_idx, w_gate, w_up, w_down):
        G = xg.shape[0]
        slot_token, slot_entry, token_slot, dropped = route(expert_idx, E,
                                                            C)
        El = w_gate.shape[0]         # this rank's experts (E off a split)
        if El < E:
            # keep this rank's experts' slots; an entry routed to another
            # rank's expert reads the first local drop row, which holds
            # zeros, and counts as dropped here
            lo = split.offset(0, 0) * (C + 1)
            hi = lo + El * (C + 1)
            slot_token = slot_token[:, lo:hi]
            slot_entry = slot_entry[:, lo:hi]
            mine = (token_slot >= lo) & (token_slot < hi)
            token_slot = torch.where(mine, token_slot - lo, C)
            dropped = dropped | ~mine
        # dispatch: one gather (G, El * (C + 1), D); sentinel rows read 0
        xg_pad = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
        buf = _DispatchGather.apply(xg_pad, slot_token, token_slot, dropped)
        be = buf.reshape(G, El, C + 1, D)[:, :, :C]          # (G, El, C, D)
        h = expert_swiglu(be, w_gate, w_up, w_down)

        # combine: one gather (G, S, K, D), the gate-weighted sum over K
        h_flat = torch.cat([h, h.new_zeros(G, El, 1, D)], dim=2).reshape(
            G, El * (C + 1), D)
        contrib = _CombineGather.apply(h_flat, token_slot, slot_entry)
        gate_eff = gate.masked_fill(dropped, 0.0).to(h.dtype)
        return torch.einsum("gskd,gsk->gsd", contrib, gate_eff)

    weights = (p["w_gate"], p["w_up"], p["w_down"])
    El, Fl = p["w_gate"].shape[-3], p["w_gate"].shape[-1]
    served = El < E or Fl < m.d_ff_expert
    if served:
        # serving: this rank's plain slices, their offsets in the pool
        ms = sh.ModelSplit(offsets=tuple(
            (split.offset(w.shape[0], E),) + (0,) * (w.dim() - 1)
            for w in weights))
        out = experts(ms, xg, gate, expert_idx, *weights)
    else:
        # on a mesh each rank routes its own groups (split over the data
        # axes only) through its slice of the experts: under EXPERT its
        # experts' rows, under EXPERT_MLP its columns of every expert's
        # hidden width; the ranks' parts are summed over the model axis.
        # With neither bound the weights are replicated and the groups
        # split over it too
        out = sh.split_rows(experts, (xg, gate, expert_idx), weights)

    if m.n_shared_experts:
        shared = layers.swiglu(xg, p["shared_gate"], p["shared_up"],
                               p["shared_down"], cdt)
        cols = p["shared_down"].shape[-2] < m.d_ff_shared
        if served and cols:
            out = split.sum_parts(out + shared, True)
        else:
            out = (split.sum_parts(out, served)
                   + split.sum_parts(shared, cols))
    else:
        out = split.sum_parts(out, served)

    aux: Dict[str, torch.Tensor] = {}
    if need_aux:
        me = probs.mean(dim=(0, 1))
        ce = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
        aux = {"moe_load_balance": E * torch.sum(me * ce),
               "moe_z_loss": torch.mean(
                   torch.logsumexp(logits, dim=-1) ** 2)}
    out = out.to(x.dtype)
    if regrouped:
        out = out.reshape(B0, S0, D0)
    return out, aux
