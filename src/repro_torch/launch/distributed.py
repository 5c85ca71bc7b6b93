"""Guarded process-group initialisation, and a local launcher.

Port of ``repro/launch/distributed.py``. ``init_distributed``
initialises ``torch.distributed`` exactly when the environment names a
multi-process job (torchrun's ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR``) or the caller passes explicit arguments, and is a
clean no-op otherwise, so one entry point serves one process, a
torchrun job and the local launcher without branching at the call
site. It is idempotent. The backend follows the device: NCCL for
"cuda", gloo for "cpu"; nothing falls back from one to the other.

Under gloo on CUDA tensors (two ranks on one card, where NCCL refuses)
gloo carries every collective that the port issues except one:
the functional all-gather (``_c10d_functional.all_gather_into_tensor``,
which DTensor's ``Shard -> Replicate`` uses) ends the process with a
segmentation fault (torch 2.11, CUDA 12.8). ``init_distributed``
then stages that one through pinned host memory (``stage_all_gather``),
for gloo groups only; ``STAGED`` names what is staged, and nothing else
is.

``run_local`` is the port's stand-in for the JAX package's forced
host devices: it runs a function on N local ranks (spawned processes,
one torch thread each), joined by gloo (or NCCL) over a ``FileStore``
in a temporary directory, so no network is needed, and returns each
rank's result. A rank that raises fails the call with its traceback.
From the shell:

    PYTHONPATH=src python -m repro_torch.launch.distributed --ranks 8 \\
        --device cpu repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 3 --mesh 2,4 --device cpu

runs ``main(argv)`` of the named module on every rank.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_multi_process", "run_local", "main",
           "stage_all_gather", "STAGED"]

# The variables that mark a torchrun job.
_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# How long a collective may wait for a peer before it fails.
COLLECTIVE_TIMEOUT_S = 300
# How long the other ranks get to end once one has failed or timed out.
GRACE_S = 5.0
# The collectives staged through pinned host memory in this process.
STAGED: List[str] = []
_STAGING_LIB = None


def stage_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors over gloo groups
    through pinned host memory: a CUDA kernel of ``_c10d_functional.
    all_gather_into_tensor`` that copies the input to the host, runs the
    op's own kernel there and copies the result back. It refuses a group
    of another backend (an NCCL group's all-gather is not staged). For a
    process whose default group is gloo on CUDA tensors
    (``init_distributed`` calls it); idempotent."""
    global _STAGING_LIB
    if _STAGING_LIB is not None:
        return
    ops = torch.ops._c10d_functional

    def all_gather(inp, group_size, group_name):
        if _group_backend(group_name) != "gloo":
            raise RuntimeError(
                f"all_gather_into_tensor is staged for gloo groups only; "
                f"group {group_name!r} is "
                f"{_group_backend(group_name)!r}")
        host = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        out = ops.wait_tensor(ops.all_gather_into_tensor(
            host.copy_(inp), group_size, group_name))
        return out.to(inp.device)

    _STAGING_LIB = torch.library.Library("_c10d_functional", "IMPL")
    _STAGING_LIB.impl("all_gather_into_tensor", all_gather, "CUDA")
    STAGED.append("all_gather_into_tensor:pinned-host")


def _group_backend(group_name: str) -> str:
    """The backend of the process group registered as ``group_name``."""
    from torch.distributed import distributed_c10d
    return dist.get_backend(
        distributed_c10d._resolve_process_group(group_name))


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, store=None,
                     device_type: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Initialise the default process group iff this is a multi-process
    job. Returns ``is_multi_process()``.

    Explicit arguments (``init_method`` such as ``file://...`` or
    ``tcp://localhost:PORT``, or a ``store``, with ``world_size`` and
    ``rank``) force initialisation, a world of one included (a
    ``DeviceMesh`` needs a group); otherwise torchrun's variables are
    read (``env://``), and their absence means one process and no
    group. A second call reports the existing state. ``backend``
    overrides the device's (two ranks on one card must use gloo: NCCL
    refuses two ranks on one device).
    """
    if dist.is_initialized():
        return is_multi_process()
    explicit = init_method is not None or store is not None
    if not explicit and not all(os.environ.get(k) for k in _ENV_KEYS):
        return False
    backend = backend or {"cuda": "nccl", "cpu": "gloo"}[device_type]
    if device_type == "cuda":
        from repro_torch import resolve_device
        resolve_device("cuda")
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = rank if rank is not None else os.environ.get("RANK", 0)
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if explicit:
        if world_size is None or rank is None:
            raise ValueError("init_distributed: explicit initialisation "
                             "needs world_size and rank")
        dist.init_process_group(backend, init_method=init_method,
                                store=store, world_size=world_size,
                                rank=rank, timeout=timeout)
    else:
        dist.init_process_group(backend, timeout=timeout)
    if backend == "gloo" and device_type == "cuda":
        stage_all_gather()
    return is_multi_process()


def is_multi_process() -> bool:
    """True when the default group spans more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


# ---------------------------------------------------------------- launcher

def _rank_main(fn, rank, world_size, store_path, device_type, backend,
               args, results) -> None:
    torch.set_num_threads(1)
    store = None
    try:
        store = dist.FileStore(store_path, world_size)
        init_distributed(store=store, world_size=world_size, rank=rank,
                         device_type=device_type, backend=backend)
        out = fn(*args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:
        # reported to the caller, which raises with it
        results.put((rank, False, traceback.format_exc()))
        return
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # Leave only when every rank has destroyed its group: a rank that
    # exits while a peer still reads from its gloo pairs makes the
    # peer fail with "Connection closed by peer". The count lives in
    # the store's file, not on the sockets.
    store.add("exited", 1)
    while store.add("exited", 0) < world_size:
        time.sleep(0.01)


def run_local(fn: Callable, world_size: int, *args,
              device_type: str = "cpu", timeout: float = 600.0,
              backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` local ranks and return their
    results in rank order.

    Each rank is a spawned process with one torch thread, in a default
    group initialised with ``device_type``'s backend over a
    ``FileStore``. ``fn``, ``args`` and the results are pickled, so
    ``fn`` is a module-level function. If a rank raises, or the ranks
    are not done within ``timeout`` seconds, the others get ``GRACE_S``
    seconds to end, are then stopped, and this raises with every
    traceback received. Ranks that all reported have what is left of
    ``timeout`` (at least ``GRACE_S``) to exit. ``backend`` overrides the device's
    (``init_distributed``).
    """
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, failed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, store_path,
                                   device_type, backend, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failed) < world_size:
                if failed:
                    deadline = min(deadline, time.monotonic() + GRACE_S)
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(wait, 1.0))
                except queue.Empty:
                    # a rank that died before it could report (it failed
                    # to start, say) ends the wait
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in got and r not in failed]
                    if dead and results.empty():
                        for r in dead:
                            failed[r] = (f"exited with code "
                                         f"{procs[r].exitcode} before "
                                         f"reporting")
                    continue
                (got if ok else failed)[rank] = payload
            # ranks that all reported may take a while to leave on a
            # loaded machine: they get what is left of the timeout
            for p in procs:
                p.join(timeout=1.0 if failed else
                       max(GRACE_S, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    missing = sorted(set(range(world_size)) - set(got) - set(failed))
    if failed or missing:
        lines = [f"run_local: {len(failed)} of {world_size} ranks raised "
                 f"(first failure first)"
                 + (f"; ranks {missing} did not finish within "
                    f"{timeout:.0f} s" if missing else "")]
        for rank in failed:
            lines.append(f"--- rank {rank} ---\n{failed[rank]}")
        raise RuntimeError("\n".join(lines))
    bad = [p.exitcode for p in procs if p.exitcode not in (0, None)]
    if bad:
        raise RuntimeError(f"run_local: ranks exited with codes {bad}")
    return [got[r] for r in range(world_size)]


def _run_module(module: str, argv: List[str]) -> None:
    importlib.import_module(module).main(argv)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="run MODULE.main(ARGS) on N local ranks")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, the default) or cpu (gloo)")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("module")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    run_local(_run_module, a.ranks, a.module, a.args,
              device_type=a.device, timeout=a.timeout)


if __name__ == "__main__":
    main()
