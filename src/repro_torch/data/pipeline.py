"""Deterministic, shardable synthetic token pipeline (the JAX package's
`data/pipeline.py`, numpy only; batches are bit-identical to its).

Every batch is a pure function of (seed, step, shard) — a restarted or
replaced host replays the exact same data (the fault-tolerance contract the
trainer relies on).  A background prefetch thread hides
host-side generation latency (the role kernel-bypass I/O threads play in
the paper's setup).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, n_shards: int = 1, shard: int = 0,
                 zipf_alpha: float = 1.2, prefetch: int = 2,
                 frontend_tokens: int = 0, d_model: int = 0,
                 frames: int = 0):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        self.zipf_alpha = zipf_alpha
        self.frontend_tokens = frontend_tokens
        self.frames = frames
        self.d_model = d_model
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for `step` on this shard — pure and replayable."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b = self.batch // self.n_shards
        # zipf-skewed token stream (mirrors the paper's skewed key access)
        toks = rng.zipf(self.zipf_alpha, (b, self.seq_len + 1))
        toks = (toks - 1) % self.vocab_size
        out = {"tokens": toks.astype(np.int32)}
        if self.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (b, self.frontend_tokens, self.d_model)).astype(np.float32)
        if self.frames:
            out["frames"] = rng.standard_normal(
                (b, self.frames, self.d_model)).astype(np.float32)
        return out

    # -- prefetching iterator -------------------------------------------------
    def start(self, from_step: int = 0):
        self._stop.clear()

        def worker():
            step = from_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
