"""Deterministic synthetic data pipeline with host-side prefetch (a copy of
``repro.data.pipeline``).

``SyntheticCorpus`` generates a reproducible token stream (mixture of
Zipf-distributed "language" and structured patterns so the loss actually
decreases); ``TokenBatcher`` shards batches per host and prefetches ahead of
the step (compute/IO overlap)."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3

    def stream(self, seq_len: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        while True:
            base = rng.zipf(self.zipf_a, size=seq_len + 1) % v
            # structured spans: periodic repeats give learnable signal
            start = rng.integers(0, seq_len // 2)
            period = int(rng.integers(2, 8))
            span = rng.integers(0, v, size=period)
            reps = (seq_len + 1 - start) // period + 1
            patt = np.tile(span, reps)[: seq_len + 1 - start]
            base[start:] = patt
            yield base.astype(np.int32)


class TokenBatcher:
    """Yields (tokens, labels) of shape [B, S], host-sharded + prefetched."""

    def __init__(self, corpus: SyntheticCorpus, batch: int, seq_len: int,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2):
        assert batch % num_hosts == 0
        self.local_batch = batch // num_hosts
        self.seq_len = seq_len
        self._streams = [
            corpus.__class__(corpus.vocab_size,
                             seed=corpus.seed * 100003 + host_id * 1009 + i)
            .stream(seq_len)
            for i in range(self.local_batch)]
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _make(self):
        rows = np.stack([next(s) for s in self._streams])
        return rows[:, :-1], rows[:, 1:]

    def _fill(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make(), timeout=0.5)
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
