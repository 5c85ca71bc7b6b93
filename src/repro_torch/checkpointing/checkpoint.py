"""Atomic, async checkpointing with auto-resume.

Port of ``repro/checkpointing/checkpoint.py``, with the same directory
layout and key strings, so a checkpoint either package writes restores
in the other:

- ``<ckpt_dir>/step_%09d/host0.npz`` holds every leaf as a numpy array,
  keyed as ``jax.tree_util.keystr`` keys the JAX package's tree: a dict
  entry is ``['name']``, a NamedTuple field (``AdamWState``) ``.field``,
  a list item ``[i]``; so ``['params']['layers']['attn']['wq']`` and
  ``['opt'].mu['embed']``;
- ``manifest.json`` is written last, inside a ``.tmp`` directory that
  is committed by an atomic rename: a checkpoint without a manifest is
  invisible, so a crash mid-write is never restored;
- ``AsyncSaver`` copies the tree to host memory on the caller's thread
  (a consistent snapshot) and serializes it on a background thread,
  overlapping the write with the next training steps;
- ``keep_last`` garbage-collects old steps.

One host file holds the whole tree. ``restore`` places every leaf on
the device and in the dtype of the matching leaf of ``like``; with
``shardings`` (a tree aligned with ``like`` whose leaves are
``sharding.NamedSharding``, a mesh and DTensor placements, or None for
an unsharded leaf; the JAX package's ``shardings``), each leaf is loaded
whole on every rank and laid out on that mesh
(``sharding.distribute_local``: each rank keeps its own slice, with no
communication), so a checkpoint restores onto any mesh shape, whatever
mesh wrote it. A DTensor leaf of ``like`` with no sharding given is laid
out as that leaf is.

A tree with DTensor leaves (a sharded run) saves from every rank of its
mesh: each leaf is gathered whole (``full_tensor()``, a collective, in
the same order on every rank), rank 0 writes ``host0.npz`` and commits
the manifest, and a barrier follows, so no rank reads a checkpoint
before it is committed; ``AsyncSaver`` gathers on the caller's thread,
writes on rank 0's background thread, and puts the barrier in
``wait()``. The key strings and the layout are the same either way, so
each package restores the other's checkpoints, sharded or not. A leaf
that is a Python int (the port's ``AdamWState.step``) is stored as an
int32 scalar, as the JAX package stores its step.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..dist import sharding as sh


def _map(fn, tree, prefix=""):
    """The tree with every leaf replaced by ``fn(keystr, leaf)``; keys in
    ``jax.tree_util.keystr``'s notation."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, n), f"{prefix}.{n}")
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _items(tree):
    """(keystr, leaf) for every leaf."""
    out = []
    _map(lambda k, v: out.append((k, v)), tree)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if sh.is_dtensor(t):
            t = t.full_tensor()            # a collective: every rank
        if t.dtype == torch.bfloat16:      # numpy has no bfloat16
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _distributed(tree) -> bool:
    """Does the tree hold DTensor leaves (a sharded run, whose every rank
    saves)?"""
    return any(sh.is_dtensor(v) for _, v in _items(tree))


def _writer() -> bool:
    """Rank 0 writes (every process off a process group)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3,
         extra: Optional[Dict] = None) -> str:
    """Synchronous checkpoint of a tree of tensors (and Python ints). A
    tree with DTensor leaves is saved from every rank of its mesh: rank
    0 writes, then all meet at a barrier (module docstring)."""
    arrays = {k: _to_numpy(v) for k, v in _items(tree)}
    if not _distributed(tree):
        return _write(ckpt_dir, step, arrays, keep_last, extra)
    if _writer():
        _write(ckpt_dir, step, arrays, keep_last, extra)
    _barrier()
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _write(ckpt_dir, step, arrays, keep_last, extra) -> str:
    """Write host arrays as one step's checkpoint and commit it."""
    tmp = os.path.join(ckpt_dir, f"step_{step:09d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "host0.npz"), **arrays)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(ckpt_dir, keep_last)
    return final


class AsyncSaver:
    """Background-thread checkpointing; at most one save in flight. A
    tree with DTensor leaves is gathered on the caller's thread of every
    rank, written on rank 0's background thread, and ``wait()`` (which
    every rank calls at the same points: before the next save and at the
    end of a run) ends with a barrier."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._shared = False       # a sharded save is in flight

    def save_async(self, ckpt_dir: str, step: int, tree: Any, **kw):
        self.wait()
        # device -> host on the caller's thread (a consistent snapshot),
        # serialize + write on the background thread
        self._shared = _distributed(tree)
        snapshot = _map(lambda _, v: _to_numpy(v), tree)
        if self._shared and not _writer():
            return
        self._thread = threading.Thread(
            target=save, args=(ckpt_dir, step, snapshot), kwargs=kw,
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._shared:
            self._shared = False
            _barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _from_numpy(key, arr, like, sharding=None):
    """A stored array as the leaf ``like`` is, laid out by ``sharding``
    (a ``NamedSharding``; None: as ``like`` is, a DTensor's layout
    included)."""
    if torch.is_tensor(like):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape},"
                             f" expected {tuple(like.shape)}")
        if sharding is None and sh.is_dtensor(like):
            sharding = sh.NamedSharding(like.device_mesh,
                                        tuple(like.placements))
        local = like.to_local() if sh.is_dtensor(like) else like
        t = torch.from_numpy(np.array(arr)).to(local.device, like.dtype)
        if sharding is None:
            return t
        return sh.distribute_local(t, sharding.mesh, sharding.placements)
    if isinstance(like, int):
        return int(arr)
    return np.array(arr)


def _leaf_shardings(shardings, like):
    """``shardings`` as a flat key -> NamedSharding map over ``like``'s
    leaves (None: none given)."""
    if shardings is None:
        return {}
    out = {}

    def walk(s, t, prefix):
        if s is None:
            return
        if isinstance(t, dict):
            for k in t:
                walk(s.get(k) if isinstance(s, dict) else None, t[k],
                     f"{prefix}[{k!r}]")
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for n in t._fields:
                walk(getattr(s, n, None), getattr(t, n), f"{prefix}.{n}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(s[i], v, f"{prefix}[{i}]")
        else:
            out[prefix] = s
    walk(shardings, like, "")
    return out


def restore(ckpt_dir: str, step: int, like: Any, shardings=None) -> Any:
    """Restore into the structure of ``like``: each tensor on the device
    and in the dtype of ``like``'s leaf, laid out by ``shardings`` (module
    docstring) where it gives one."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        json.load(f)
    where = _leaf_shardings(shardings, like)
    with np.load(os.path.join(path, "host0.npz")) as data:
        missing = {k for k, _ in _items(like)} - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}...")
        return _map(lambda k, v: _from_numpy(k, data[k], v, where.get(k)),
                    like)


def restore_latest(ckpt_dir: str, like: Any, shardings=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like, shardings)


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
