"""PyTorch/CUDA port of the ``repro`` serving stack (NVIDIA H100).

Mirrors the JAX package's sub-package and module names (``configs``,
``models``, ``kernels``, ``serve``, ``launch``), so every module has
one reference module in ``src/repro``. It imports ``torch`` and never
``jax`` or ``repro``. Entry points run on the card unless the caller
asks for the CPU (``device="cpu"``), which is how the CPU tests drive
the plain versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking
    for it on a machine without a card raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless the caller passes device='cpu'")
    return dev
