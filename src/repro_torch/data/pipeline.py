"""Data pipeline (port of ``repro.data.pipeline``): deterministic synthetic
corpus, document packing, host feed with background prefetch.

Pure numpy, kept as the port's own copy so the port imports nothing of the
reference.  The corpus is a seeded synthetic token stream (documents with
Zipf-ish lengths and a Markov-ish token process), deterministic in
(seed, host shard, step): batches are bitwise equal to the reference's for
the same seed and step, and a restarted job resumes bit-identically from
the checkpointed step without any data-state checkpointing.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512


def _doc_stream(rng: np.random.Generator, vocab: int, mean_len: int
                ) -> Iterator[np.ndarray]:
    """Endless stream of synthetic 'documents'."""
    while True:
        n = int(np.clip(rng.zipf(1.6) * (mean_len // 8), 8, 8 * mean_len))
        # cheap Markov-ish structure: tokens correlate with their prefix
        base = rng.integers(1, vocab, size=n)
        drift = rng.integers(0, 7, size=n)
        doc = (base + np.cumsum(drift)) % (vocab - 1) + 1  # avoid eos id 0
        yield doc.astype(np.int32)


def pack_documents(docs: Iterator[np.ndarray], seq_len: int, eos_id: int
                   ) -> Iterator[np.ndarray]:
    """Greedy packing of docs into fixed-length rows with EOS separators."""
    buf: list[int] = []
    for doc in docs:
        buf.extend(doc.tolist())
        buf.append(eos_id)
        while len(buf) >= seq_len + 1:
            yield np.asarray(buf[: seq_len + 1], np.int32)
            buf = buf[seq_len + 1:]


class HostDataLoader:
    """Per-host shard of the global batch, deterministic in step index.

    Each host draws from an independent substream keyed by
    (seed, host_index); `batch_at(step)` is reproducible — a restarted job
    re-reads the same data for the same step.
    """

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1, prefetch: int = 2):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // host_count
        self.host_index = host_index
        self._row_cache: dict[int, np.ndarray] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._cursor = 0
        self._thread: Optional[threading.Thread] = None

    def _rows_for_step(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.cfg.seed, self.host_index, step))
        packer = pack_documents(
            _doc_stream(rng, self.cfg.vocab, self.cfg.mean_doc_len),
            self.cfg.seq_len, self.cfg.eos_id)
        return np.stack([next(packer) for _ in range(self.local_batch)])

    def batch_at(self, step: int) -> dict:
        rows = self._rows_for_step(step)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    # ---- background prefetch ------------------------------------------
    def start(self, start_step: int = 0):
        self._cursor = start_step

        def worker():
            s = start_step
            while True:
                self._q.put((s, self.batch_at(s)))
                s += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self) -> tuple[int, dict]:
        if self._thread is None:
            b = self.batch_at(self._cursor)
            self._cursor += 1
            return self._cursor - 1, b
        return self._q.get()
