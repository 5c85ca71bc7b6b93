"""Hand-written Hopper kernels, one package per hot spot.

Each package keeps the JAX package's three-file pattern:

- ``ref.py``: the plain PyTorch version (used for CPU tensors, and the
  oracle the kernel is held to on the card);
- ``kernel.py``: the ctypes wrapper around the CUDA kernel — it checks
  device, dtype, shape and contiguity, allocates the output, launches
  on the current stream and counts its launches;
- ``ops.py``: dispatch — the kernel for a CUDA tensor, the plain
  version for a CPU tensor, nothing else.

CUDA sources live in ``csrc/``. Each ``<name>.cu`` has a plain C
interface and is compiled at first use with ``nvcc`` into its own
shared library under ``build/repro_torch/`` at the root of the checkout
(``build_all`` compiles several at once, one ``nvcc`` each), then loaded
with ``ctypes``. Every C entry returns ``cudaGetLastError()`` after its
launch; ``check`` turns a non-zero code into an exception.

``csrc/graph_loop.cu`` is built the same way but is not a kernel: it
builds the CUDA-graph WHILE and IF nodes of ``core.device_loop``.

Launch counts. Each wrapper adds one to its Python ``launches`` counter
where it launches, and calls ``count_launch``: inside
``device_launch_counts`` while a CUDA graph is being captured, that
captures an add of one to a device counter beside the kernel, so every
replay of the graph counts the launches it really makes (a captured call
launches nothing when Python makes it).

Packages: paged_attention (single-token GQA decode through the block
table), flash_prefill (causal chunk attention through the block table),
selective_scan (the mamba1 recurrence, over a whole prompt), lstm_cell (one
fused LSTM step of ``dynamic_rnn``: the GEMM and the gates),
flash_attention (the full-sequence GQA forward of mode ``full``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
ARCH_TAG = "sm_90a"

# every kernel of the port, one csrc/<name>.cu each
KERNELS = ("paged_attention", "flash_prefill", "selective_scan", "lstm_cell",
           "flash_attention")
# every source built: the kernels and the CUDA-graph control flow of
# core.device_loop (conditional nodes, no kernel of the JAX package)
SOURCES = KERNELS + ("graph_loop",)

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}
# (counts, names) armed by device_launch_counts, innermost last, per
# thread: a capture (and its stream) belongs to the thread that runs it,
# and a serving front-end steps its scheduler on a worker thread
_ARMED = threading.local()


def _device_counts() -> List[Tuple[torch.Tensor, Tuple[str, ...]]]:
    if not hasattr(_ARMED, "stack"):
        _ARMED.stack = []
    return _ARMED.stack


@contextlib.contextmanager
def device_launch_counts(counts: torch.Tensor, names: Sequence[str]):
    """Count launches on the device in the graphs this thread captures
    inside this context: ``counts[i]`` (an integer CUDA tensor allocated
    outside capture) counts the launches of ``names[i]``."""
    stack = _device_counts()
    stack.append((counts, tuple(names)))
    try:
        yield
    finally:
        stack.pop()


def count_launch(name: str) -> None:
    """Called where a wrapper launches ``name``: under capture inside
    ``device_launch_counts``, captures an add of one to its device
    counter. Eager launches are counted by the Python counter alone."""
    stack = _device_counts()
    if not stack:
        return
    counts, names = stack[-1]
    if name in names and counts.is_cuda and \
            torch.cuda.is_current_stream_capturing():
        counts[names.index(name)].add_(1)


def on_cuda(t: torch.Tensor) -> bool:
    """Dispatch probe: does this tensor live on a CUDA device? The
    counterpart of the JAX package's ``on_tpu``; every ``ops.py`` and
    everything that reports which path ran keys off it. A DTensor is
    refused: a kernel and its plain version read one rank's local
    tensors (``to_local()``), never a sharded view."""
    _refuse_dtensor(t)
    return t.device.type == "cuda"


def _refuse_dtensor(t) -> None:
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is not None and isinstance(t, mod.DTensor):
        raise TypeError("a kernel reads a rank's local tensors: pass "
                        "DTensor.to_local(), not the DTensor")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: Iterable[str] = SOURCES
              ) -> Dict[str, Tuple[float, str]]:
    """Compile ``csrc/<name>.cu`` for every name not built yet (every
    source of the port by default), one
    ``nvcc`` process each, all started together. Returns
    ``{name: (seconds, ptxas report)}`` for the sources compiled by this
    call (a library already on disk with the same source digest is
    reused). Raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter(),
                       tmp, out)
    report = {}
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        report[name] = (secs, log)
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> Callable[..., int]:
    """The C entry ``symbol`` of ``csrc/<name>.cu``, its ``argtypes``
    and ``restype`` (``cudaError_t`` as int) bound once, when the
    library is loaded, not on every launch."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    _refuse_dtensor(t)
    return ctypes.c_void_p(t.data_ptr())


def dtype_code(t: torch.Tensor) -> int:
    """0 = float32, 1 = bfloat16: the two types the kernels take."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def validate_block_table_call(q, k_pool, v_pool, table, pos, what,
                              align=16, q_head0=0, n_heads=None):
    """Checks shared by both block-table kernels (one CUDA device, the
    dtypes, contiguity, alignment, hd in (64, 128), the shapes, the head
    range); returns (block, KV, bpr, n_heads). q and the pools must be
    ``align``-byte aligned, the width of the kernel's copies of them (16
    for ``cp.async`` and 16-byte loads); the int32 table and lengths,
    which the kernels read one int at a time, 4-byte aligned. q's H heads
    are ``[q_head0, q_head0 + H)`` of ``n_heads`` (default: H), which the
    pools' KV heads must divide."""
    tensors = (q, k_pool, v_pool, table, pos)
    if any(t.device != q.device or t.device.type != "cuda"
           for t in tensors):
        raise ValueError(f"{what}: every operand must be on one CUDA "
                         f"device")
    dtype_code(q)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: pools must have q's dtype {q.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{what}: table and lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if any(t.data_ptr() % align for t in (q, k_pool, v_pool)) or \
            any(t.data_ptr() % 4 for t in (table, pos)):
        raise ValueError(f"{what}: q and the pools must be {align}-byte "
                         f"aligned (the kernel's copies of them are up to "
                         f"{align} bytes wide), the table and lengths "
                         f"4-byte aligned")
    B, _, H, hd = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: pools must both be (n_blocks, block, "
                         f"KV, hd)")
    _, block, KV, phd = k_pool.shape
    n_heads = H if n_heads is None else int(n_heads)
    if phd != hd or hd not in (64, 128) or n_heads % KV:
        raise ValueError(f"{what}: needs hd in (64, 128) matching the "
                         f"pools and n_heads % KV == 0; got q "
                         f"{tuple(q.shape)}, {n_heads} heads, pools "
                         f"{tuple(k_pool.shape)}")
    if not 0 <= q_head0 <= n_heads - H:
        raise ValueError(f"{what}: the head range [{q_head0}, "
                         f"{q_head0 + H}) lies outside {n_heads} heads")
    if table.dim() != 2 or table.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"{what}: table must be (B, bpr) and lengths "
                         f"(B,) for B = {B}")
    return block, KV, table.shape[1], n_heads
