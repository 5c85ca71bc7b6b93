"""Quickstart: the paper's control-flow API in a page, the JAX
package's ``examples/quickstart.py`` in the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Five sections: a ``while_loop`` whose trip count depends on the data;
its reverse-mode gradient (§5.1); the same gradient with the tape
swapped to host memory (``save_policy="offload"``, §5.3); ``scan`` and a
``TensorArray``; ``cond``. Every loop runs under ``impl="host"``, the
differentiable lowering: the loop and its gradient run eagerly on the
device, and a data-dependent predicate is read on the host once an
iteration. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from .. import resolve_device
from ..core import TensorArray, cond, scan, while_loop


def run(device="cuda") -> Dict[str, object]:
    """The five sections; returns their values (floats and lists)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    # --- 1. a dynamic while_loop with a data-dependent trip count ------
    n, v = while_loop(lambda c: c[1] < 100.0,
                      lambda c: (c[0] + 1, c[1] * 1.7),
                      (torch.zeros((), dtype=torch.int32, device=dev),
                       f32(1.0)), max_iters=50)
    print(f"loop ran {int(n)} iterations -> {float(v):.2f}")

    # --- 2. ...and it is reverse-differentiable (paper §5.1) ----------
    x, w = f32(0.3).requires_grad_(), f32(1.2).requires_grad_()
    _, y = while_loop(lambda c: c[0] < 5,
                      lambda c: (c[0] + 1, torch.tanh(c[1] * w)),
                      (0, x), max_iters=8)
    dx, dw = torch.autograd.grad(y, (x, w))
    print(f"d/dx = {float(dx):.4f}   d/dw (summed over iterations) = "
          f"{float(dw):.4f}")

    # --- 3. memory policies: swap the gradient tape to host (§5.3) -----
    x = f32(0.5).requires_grad_()
    _, y = while_loop(lambda c: c[0] < 5,
                      lambda c: (c[0] + 1, torch.sin(c[1])),
                      (0, x), max_iters=8, save_policy="offload")
    (g_offload,) = torch.autograd.grad(y, (x,))
    print(f"offload-policy gradient: {float(g_offload):.4f} (same math, "
          f"host tape)")

    # --- 4. TensorArrays + the Fig. 2 scan ------------------------------
    xs = torch.arange(6.0, device=dev)
    sums = scan(lambda c, x: c + x, xs, f32(0.0))
    print("scan (prefix sums):", sums.tolist())
    ta = TensorArray.unstack(torch.arange(4.0, device=dev))
    read2 = float(ta.read(2))
    print("TensorArray read(2):", read2)

    # --- 5. conditionals ------------------------------------------------
    c = cond(torch.tensor(True, device=dev), lambda v: v * 2,
             lambda v: v - 1, f32(21.0))
    print("cond:", float(c))
    return {"iterations": int(n), "value": float(v), "dx": float(dx),
            "dw": float(dw), "offload_grad": float(g_offload),
            "scan": sums.tolist(), "ta_read": read2, "cond": float(c)}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
