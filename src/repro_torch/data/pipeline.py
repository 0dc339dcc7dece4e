"""Sharded deterministic input pipeline with prefetch and skip-resume.

The port's own copy of ``repro.data.pipeline`` (numpy only): the batches
(``Loader.batch_for_step`` and ``iterate``) are the reference's, numpy
int32 arrays; the caller moves them to its device.

Design for 1000+ nodes:

* ``batch_for_step(step)`` is a **pure function** of (step, rank): restart
  and elastic re-mesh replay identically with zero coordination — this is
  the skip-resume mechanism (no iterator state to checkpoint).
* Each data-parallel rank reads a disjoint, strided slice of the token
  stream (memmap: bounded-latency reads — no network tail / stragglers).
* A background thread prefetches ``depth`` steps ahead (host-side double
  buffering; the device-side analogue is the BaM software pipeline in
  ``core/pipeline.py``).
* ``skip_slow_shard``: if a rank's read exceeds ``slow_ms``, the loader
  serves that rank's *previous* batch instead of stalling the step's
  collectives (bounded-staleness straggler mitigation).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from repro_torch.data.tokens import TokenStore

__all__ = ["DataConfig", "Loader", "make_loader"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    n_ranks: int = 1
    rank: int = 0
    prefetch_depth: int = 2
    skip_slow_shard: bool = False
    slow_ms: float = 100.0


class Loader:
    def __init__(self, store: TokenStore, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_ranks == 0
        self.store = store
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_ranks
        self._prev = None
        self._q: Optional[queue.Queue] = None
        self._thread = None
        self._stop = threading.Event()

    # -- deterministic addressing ------------------------------------
    def batch_for_step(self, step: int) -> dict:
        """Pure (step, rank) -> batch; the skip-resume primitive."""
        cfg = self.cfg
        span = cfg.seq_len + 1
        t0 = time.monotonic()
        rows = []
        for b in range(self.local_batch):
            gidx = step * cfg.global_batch + self.cfg.rank \
                * self.local_batch + b
            offset = (gidx * span * 7919) % max(self.store.n_tokens - span,
                                                1)
            rows.append(self.store.read(offset, span))
        took_ms = (time.monotonic() - t0) * 1e3
        arr = np.stack(rows)
        if self.cfg.skip_slow_shard and took_ms > self.cfg.slow_ms \
                and self._prev is not None:
            return self._prev                   # bounded staleness
        batch = {"tokens": arr[:, :-1].astype(np.int32),
                 "labels": arr[:, 1:].astype(np.int32)}
        self._prev = batch
        return batch

    # -- prefetching iterator ----------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        cfg = self.cfg
        q: queue.Queue = queue.Queue(maxsize=cfg.prefetch_depth)
        self._q = q
        self._stop.clear()

        def worker():
            s = start_step
            while not self._stop.is_set():
                try:
                    q.put((s, self.batch_for_step(s)), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        try:
            while True:
                s, b = q.get()
                yield b
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass


def make_loader(store_path, seq_len: int, global_batch: int, *,
                n_ranks: int = 1, rank: int = 0, **kw) -> Loader:
    store = TokenStore.open(store_path)
    return Loader(store, DataConfig(seq_len=seq_len,
                                    global_batch=global_batch,
                                    n_ranks=n_ranks, rank=rank, **kw))
