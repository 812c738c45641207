"""Deterministic, resumable, sharded token pipeline (``repro.data.
pipeline``).

- ``SyntheticLM``: hash-seeded token stream (the reference's numpy
  generator, so the same ``(seed, step, rank)`` gives the same tokens in
  both packages): deterministic in (step, dp_rank), so a restart at step
  k reproduces the exact batch sequence.
- ``BinTokenSource``: memory-mapped flat token file (the production path).
- ``Prefetcher``: background-thread double buffering.

Each DP rank pulls only its slice of the global batch; ``global_batch``
must divide by the number of ranks.  Batches are tensors on the device
the caller names (default ``cuda``): ``tokens`` / ``labels`` int32 and
``mask`` float32, each (local_batch, seq_len).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def _batch(toks: np.ndarray, device: torch.device) -> dict:
    B, S1 = toks.shape
    return {
        "tokens": torch.as_tensor(toks[:, :-1].astype(np.int32),
                                  device=device),
        "labels": torch.as_tensor(toks[:, 1:].astype(np.int32),
                                  device=device),
        "mask": torch.ones((B, S1 - 1), dtype=torch.float32, device=device),
    }


class SyntheticLM:
    """Deterministic synthetic LM data with learnable structure."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 n_ranks: int = 1, rank: int = 0, seed: int = 0,
                 device=None):
        if global_batch % n_ranks:
            raise ValueError(f"global_batch {global_batch} does not divide "
                             f"by {n_ranks} ranks")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_ranks
        self.rank = rank
        self.seed = seed
        self.device = resolve_device(device)
        # fixed random bigram table: next ~ (prev * a + c) mod V with noise
        self._a = 6364136223846793005 % vocab_size or 1
        self._c = 1442695040888963407 % vocab_size

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.rank)
        B, S, V = self.local_batch, self.seq, self.vocab
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S))
        rand_tok = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * self._a + self._c) % V
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, nxt, rand_tok[:, t])
        return _batch(toks, self.device)

    def iter_from(self, step: int) -> Iterator[dict]:
        while True:
            yield self.batch_at(step)
            step += 1


class BinTokenSource:
    """Flat binary token file (uint16/uint32), memory-mapped; rank-sliced,
    deterministic in step for resume."""

    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 global_batch: int, *, dtype=np.uint16, n_ranks: int = 1,
                 rank: int = 0, device=None):
        if global_batch % n_ranks:
            raise ValueError(f"global_batch {global_batch} does not divide "
                             f"by {n_ranks} ranks")
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_ranks
        self.global_batch = global_batch
        self.rank = rank
        self.n_ranks = n_ranks
        self.n_windows = (len(self.tokens) - 1) // seq_len
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        B, S = self.local_batch, self.seq
        base = (step * self.global_batch + self.rank * B) % self.n_windows
        rows = [(base + i) % self.n_windows for i in range(B)]
        toks = np.stack([np.asarray(self.tokens[r * S: r * S + S + 1])
                         for r in rows]).astype(np.int64)
        return _batch(np.clip(toks, 0, self.vocab - 1), self.device)

    def iter_from(self, step: int) -> Iterator[dict]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue (overlap host data
    work with device compute)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
