"""Data pipeline: deterministic synthetic LM stream + memmap corpus.

Port of ``repro/data/pipeline.py`` (numpy only, copied). The batch for
(step, host) is a pure function of (seed, step, host), so a restarted
host replays the exact token stream from its checkpoint's step, and
``SyntheticLM`` gives the JAX package's batches bit for bit, its
``patches`` (a VLM's patch embeddings) and ``frames`` (an audio
model's frame embeddings, which its encoder reads) included.
Prefetch is a double-buffered background thread. Batches are numpy
arrays; the train step moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Synthetic token stream with next-token structure:
    ``t[i+1] = (31 * t[i] + noise) mod vocab``, noise in [0, 7), so a
    model can reduce its loss on it. ``frames`` and ``patches`` are
    per-row shapes of standard-normal float32 stubs, drawn after the
    tokens from the same generator."""

    def __init__(self, vocab: int, seq_len: int, batch: int, *,
                 seed: int = 0, host: int = 0, n_hosts: int = 1,
                 frames: Optional[tuple] = None,
                 patches: Optional[tuple] = None):
        assert batch % n_hosts == 0
        self.vocab, self.seq_len = vocab, seq_len
        self.local_batch = batch // n_hosts
        self.seed, self.host = seed, host
        self.frames, self.patches = frames, patches

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        B, S, V = self.local_batch, self.seq_len, self.vocab
        t0 = rng.integers(0, V, size=(B, 1))
        mult = 31
        steps = rng.integers(0, 7, size=(B, S))  # small noise
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, 0:1] = t0
        for i in range(S):
            toks[:, i + 1] = (toks[:, i] * mult + steps[:, i]) % V
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.frames:
            out["frames"] = rng.standard_normal(
                (B, *self.frames), dtype=np.float32)
        if self.patches:
            out["patches"] = rng.standard_normal(
                (B, *self.patches), dtype=np.float32)
        return out


class MemmapCorpus:
    """Packed-token corpus from a flat uint16/uint32 file on disk."""

    def __init__(self, path: str, vocab: int, seq_len: int, batch: int, *,
                 dtype=np.uint16, host: int = 0, n_hosts: int = 1):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab, self.seq_len = vocab, seq_len
        self.local_batch = batch // n_hosts
        self.host, self.n_hosts = host, n_hosts
        self.n_seqs = (len(self.data) - 1) // seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.local_batch, self.seq_len
        base = (step * B * self.n_hosts + self.host * B) % max(
            self.n_seqs - B, 1)
        toks = np.stack([
            self.data[(base + i) * S:(base + i) * S + S + 1]
            for i in range(B)]).astype(np.int32)
        return {"tokens": toks[:, :-1] % self.vocab,
                "labels": toks[:, 1:] % self.vocab}


class Prefetcher:
    """Double-buffered background prefetch (host data prep overlaps the
    device's work)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
