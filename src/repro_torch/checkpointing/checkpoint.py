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

The port runs on one card: one host file, and ``restore`` places every
leaf on the device and in the dtype of the matching leaf of ``like``
(the JAX package's ``shardings`` argument has no counterpart). A leaf
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
        if t.dtype == torch.bfloat16:      # numpy has no bfloat16
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3,
         extra: Optional[Dict] = None) -> str:
    """Synchronous checkpoint of a tree of tensors (and Python ints)."""
    tmp = os.path.join(ckpt_dir, f"step_{step:09d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _items(tree)}
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
    """Background-thread checkpointing; at most one save in flight."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save_async(self, ckpt_dir: str, step: int, tree: Any, **kw):
        self.wait()
        # device -> host on the caller's thread (a consistent snapshot),
        # serialize + write on the background thread
        snapshot = _map(lambda _, v: _to_numpy(v), tree)
        self._thread = threading.Thread(
            target=save, args=(ckpt_dir, step, snapshot), kwargs=kw,
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _from_numpy(key, arr, like):
    """A stored array as the leaf ``like`` is."""
    if torch.is_tensor(like):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape},"
                             f" expected {tuple(like.shape)}")
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
    if isinstance(like, int):
        return int(arr)
    return np.array(arr)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each tensor on the device
    and in the dtype of ``like``'s leaf."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        json.load(f)
    with np.load(os.path.join(path, "host0.npz")) as data:
        missing = {k for k, _ in _items(like)} - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}...")
        return _map(lambda k, v: _from_numpy(k, data[k], v), like)


def restore_latest(ckpt_dir: str, like: Any):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like)


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
