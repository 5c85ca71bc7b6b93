"""LSTM + ``dynamic_rnn``: the paper's flagship application (§6.2-6.4).

``dynamic_rnn`` is built as the paper describes and as the JAX package's
``models/rnn.py`` builds it: a ``core.while_loop`` over time steps that
reads its inputs from a TensorArray and writes its outputs to another,
with per-example sequence lengths (outputs past each length are zero,
the state is frozen past it). It therefore inherits the loop's
reverse-mode AD and its §5.3 save policies: ``save_policy="offload"``
is Table 1's setting (saved values swapped to host memory).

The cell's matmul is the hot spot. ``kernels.lstm_cell`` is the fused
CUDA version; it is forward-only, as the JAX package's Pallas cell is,
so training runs the unfused cell (the default) and an inference pass
may pass ``cell=functools.partial(lstm_cell, kernel=ops.lstm_cell)``.

``impl`` picks the loop's lowering. Under ``"host"`` (the default) the
trip count ``max(seq_lens)`` is a data-dependent predicate that the loop
reads to the host once per step (``while_loop.host_reads``); without
``seq_lens`` the loop is counted and reads nothing. Under ``"graph"``
(CUDA tensors) the step counter is a 0-d device tensor, the arrays are
``DeviceTensorArray``s and ``t < max(lens)`` is decided on the device:
a forward pass is one CUDA-graph launch with no host read, and under
grad, under any save policy (the default ``all`` pushes the cell's
residuals; ``offload`` keeps them in pinned host memory), the gradient
is a second launch (``core.device_grad``). The fused cell may run inside the
graph's WHILE node on an inference pass (it launches on the current
stream); its Python ``launches`` counter counts at capture, so the
launches of a replay are the loop's iterations
(``while_loop.last_grad_loop.iterations()``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from .. import core


def lstm_init(gen: torch.Generator, input_dim: int, hidden: int,
              dtype=torch.float32) -> Dict:
    """Fused (input + hidden) -> 4 gates [i, f, g, o] weights, normal with
    std 1/sqrt(input_dim + hidden), and zero biases, drawn from ``gen`` on
    its device. The JAX package's rule; the numbers differ from its
    draws."""
    scale = 1.0 / math.sqrt(input_dim + hidden)
    w = torch.randn(input_dim + hidden, 4 * hidden, generator=gen,
                    device=gen.device, dtype=torch.float32) * scale
    return {"w": w.to(dtype),
            "b": torch.zeros(4 * hidden, dtype=dtype, device=gen.device)}


def lstm_cell(params: Dict, x, state, *, kernel=None):
    """x: (B, D); state: (c, h) each (B, H). Returns (y, new_state).
    ``kernel(w, b, x, c, h) -> (c_new, h_new)`` replaces the unfused
    math (``kernels.lstm_cell.ops.lstm_cell``)."""
    c, h = state
    if kernel is not None:
        c_new, h_new = kernel(params["w"], params["b"], x, c, h)
        return h_new, (c_new, h_new)
    z = torch.cat([x, h], dim=-1) @ params["w"] + params["b"]
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, (c_new, h_new)


def dynamic_rnn(cell_params: Dict, inputs: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None, *,
                hidden: int, save_policy: str = "all",
                parallel_iterations: int = 1,
                cell=lstm_cell, impl: str = "host"
                ) -> Tuple[torch.Tensor, Tuple]:
    """Paper §2.2 dynamic_rnn: while_loop + TensorArrays.

    inputs: (B, S, D); seq_lens: (B,) or None; impl: "host" or "graph"
    (see the module docstring).
    Returns (outputs (B, S, H), final_state (c, h)).
    """
    B, S, _ = inputs.shape
    dev, dt = inputs.device, inputs.dtype
    if impl not in ("host", "graph"):
        raise ValueError(f"unknown dynamic_rnn impl {impl!r}")
    ta_cls = core.DeviceTensorArray if impl == "graph" else core.TensorArray
    # time-major once (the JAX swapaxes), so each step reads a contiguous
    # (B, D) slice
    in_ta = ta_cls.unstack(inputs.transpose(0, 1).contiguous())
    out_ta = ta_cls.create(S, (B, hidden), dt, dev)
    c0 = torch.zeros(B, hidden, dtype=dt, device=dev)
    h0 = torch.zeros(B, hidden, dtype=dt, device=dev)
    # the step counter: a Python int on the host, a 0-d tensor on the card
    t0 = (torch.zeros((), dtype=torch.long, device=dev) if impl == "graph"
          else 0)
    if seq_lens is None:
        cond_fn, lens = None, None
    else:
        lens = torch.as_tensor(seq_lens, device=dev).long()
        lens_max = lens.max()

        def cond_fn(state):
            # dynamic trip count: stop once every sequence is exhausted
            return state[0] < lens_max

    def body_fn(state):
        t, c, h, ta = state
        y, (c2, h2) = cell(cell_params, in_ta.read(t), (c, h))
        if lens is not None:
            active = (t < lens)[:, None]
            c2 = torch.where(active, c2, c)
            h2 = torch.where(active, h2, h)
            y = torch.where(active, y, torch.zeros((), dtype=y.dtype,
                                                   device=dev))
        return (t + 1, c2, h2, ta.write(t, y))

    _, c, h, out = core.while_loop(
        cond_fn, body_fn, (t0, c0, h0, out_ta), max_iters=S,
        save_policy=save_policy, parallel_iterations=parallel_iterations,
        name="dynamic_rnn", impl=impl)
    return out.stack().transpose(0, 1), (c, h)


def static_rnn(cell_params: Dict, inputs: torch.Tensor, *, hidden: int,
               cell=lstm_cell) -> Tuple[torch.Tensor, Tuple]:
    """Statically unrolled baseline (the paper's Fig. 14 comparison)."""
    B, S, _ = inputs.shape
    c = torch.zeros(B, hidden, dtype=inputs.dtype, device=inputs.device)
    h = torch.zeros_like(c)
    ys = []
    for t in range(S):
        y, (c, h) = cell(cell_params, inputs[:, t].contiguous(), (c, h))
        ys.append(y)
    return torch.stack(ys, dim=1), (c, h)


def multilayer_lstm_params(gen: torch.Generator, n_layers: int,
                           input_dim: int, hidden: int, dtype=torch.float32):
    return [lstm_init(gen, input_dim if i == 0 else hidden, hidden, dtype)
            for i in range(n_layers)]


def multilayer_dynamic_rnn(params_list, inputs, *, hidden: int,
                           save_policy: str = "all",
                           stage_fn=None, impl: str = "host",
                           cell=lstm_cell) -> torch.Tensor:
    """Stacked LSTM (paper §6.4 model-parallel workload).

    ``stage_fn(layer_idx, fn, x)`` lets a caller place each layer (the
    JAX package's pipeline stages); identity by default. ``impl`` and
    ``cell`` go to each layer's ``dynamic_rnn``.
    """
    x = inputs
    for i, p in enumerate(params_list):
        run = functools.partial(dynamic_rnn, p, hidden=hidden,
                                save_policy=save_policy, impl=impl,
                                cell=cell)
        if stage_fn is not None:
            x = stage_fn(i, lambda xx, run=run: run(xx)[0], x)
        else:
            x, _ = run(x)
    return x
