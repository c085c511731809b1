"""Data pipeline: deterministic synthetic token stream + host-side prefetch.

A copy of ``repro/data/pipeline.py``, code unchanged (plain numpy), so the
port trains on the reference's batches bit for bit.

Two configuration-wall-relevant properties:

* **Determinism & shardability** — batch ``i`` for data-shard ``s`` is a pure
  function of ``(seed, i, s)``, so any host in a multi-pod job can produce
  exactly its shard without coordination, and elastic rescaling (a host
  taking over another's shard range) needs no data-state handoff.

* **Prefetch = configuration–computation overlap** — the background thread
  prepares batch N+1 (the host-side "configuration" of the next launch)
  while the device runs step N, which is precisely the paper's §5.5 overlap
  applied at the data layer. ``repro_torch.dispatch`` measures the win.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticLMDataset:
    """Zipf-distributed token stream with next-token labels."""

    vocab_size: int
    seq_len: int
    batch_size: int  # per-shard batch
    seed: int = 0
    zipf_a: float = 1.2

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard, n_shards])
        )
        raw = rng.zipf(self.zipf_a, size=(self.batch_size, self.seq_len + 1))
        tokens = np.minimum(raw - 1, self.vocab_size - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class PrefetchIterator:
    """Wraps a ``step -> batch`` function with a background prefetch thread."""

    def __init__(self, fetch, depth: int = 2, start_step: int = 0):
        self._fetch = fetch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fetch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)


def make_train_iterator(
    vocab_size: int,
    seq_len: int,
    batch_size: int,
    *,
    seed: int = 0,
    shard: int = 0,
    n_shards: int = 1,
    prefetch: int = 2,
    start_step: int = 0,
) -> PrefetchIterator:
    ds = SyntheticLMDataset(vocab_size, seq_len, batch_size, seed)
    return PrefetchIterator(
        lambda step: ds.batch(step, shard, n_shards),
        depth=prefetch,
        start_step=start_step,
    )
