"""Deterministic, shardable synthetic data pipeline (the port's own copy of
the JAX package's numpy-only module: ``batch_at`` gives its batches
exactly).

Design mirrors a production loader:
- every (step, host) pair maps to a deterministic slice of the global batch —
  restart-safe (resume from any step without replaying) and elastic-safe
  (re-sharding after a topology change yields the same global stream);
- a background prefetch thread keeps ``prefetch`` batches ready so a slow
  host (straggler) overlaps data production with device compute;
- the token stream is a mixture of repeated n-gram "documents" so the LM loss
  actually decreases during the example runs (unlike iid-random tokens).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_documents: int = 512       # distinct synthetic documents
    ngram_order: int = 3
    prefetch: int = 2


class SyntheticLM:
    """Order-k Markov synthetic corpus with deterministic per-step access."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        # ONE corpus-wide transition permutation (an order-1 Markov chain the
        # model can learn as a big lookup); documents differ by start state.
        self._k = min(4096, cfg.vocab_size)
        self._succ = rng.permutation(self._k)
        self._doc_starts = rng.randint(0, self._k, size=cfg.n_documents)

    def _document_tokens(self, doc: int, length: int, offset: int) -> np.ndarray:
        # order-1 Markov walk: t_{i+1} = succ(t_i) — exactly learnable, so
        # example losses genuinely decrease.
        state = int((self._doc_starts[doc % len(self._doc_starts)] + offset)
                    % self._k)
        out = np.empty(length, np.int64)
        for i in range(length):
            out[i] = state
            state = self._succ[state]
        return out.astype(np.int32)

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        """The deterministic (host-sharded) batch for a global step."""
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        rows = []
        for i in range(per_host):
            global_row = host_id * per_host + i
            doc = (step * cfg.global_batch + global_row) % cfg.n_documents
            offset = (step * 17 + global_row * 31) % 4096
            rows.append(self._document_tokens(doc, cfg.seq_len + 1, offset))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class PrefetchLoader:
    """Background-thread prefetcher over SyntheticLM (or any batch_at)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.source = source
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._q: queue.Queue = queue.Queue(maxsize=source.cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self.host_id, self.n_hosts)
            batch["_step"] = step
            try:
                self._q.put(batch, timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
