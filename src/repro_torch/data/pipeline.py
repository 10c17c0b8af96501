"""Deterministic synthetic data pipelines, host-sharded, with
double-buffered prefetch (the port's own copy of
``repro/data/pipeline.py``: numpy only, batch for batch the same; the
driver moves a batch to its device).

Every batch is a pure function of (seed, step, host_id) — the property
fault-tolerant training needs: after restart from step N the pipeline
replays batch N+1 exactly, on any number of hosts (elastic restore
re-partitions the host shard)."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _rng_for(dc: DataConfig, step: int) -> np.random.Generator:
    # independent stream per (seed, step, host)
    return np.random.Generator(
        np.random.Philox(key=dc.seed, counter=[step, dc.host_id, 0, 0])
    )


def synth_lm_batch(dc: DataConfig, step: int) -> dict:
    """Markov synthetic token stream over a small active alphabet:
    next = (tok + noise) % A with A = min(vocab, 32). Structured enough
    to be learnable within tens of steps at smoke scale (the unigram
    restriction alone drops loss from ln(V) to ~ln(A)), while exercising
    the full vocab-sized embedding/unembedding path."""
    rng = _rng_for(dc, step)
    b, s = dc.host_batch, dc.seq_len
    active = min(dc.vocab_size, 32)
    first = rng.integers(0, active, size=(b, 1))
    noise = rng.integers(0, 4, size=(b, s))
    toks = np.zeros((b, s + 1), np.int64)
    toks[:, :1] = first
    for t in range(1, s + 1):
        toks[:, t] = (toks[:, t - 1] + noise[:, t - 1]) % active
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
        "mask": np.ones((b, s), np.float32),
    }


def synth_image_batch(dc: DataConfig, step: int, *, image_size: int,
                      num_classes: int) -> dict:
    """Class-conditional gaussian blobs: images carry label signal."""
    rng = _rng_for(dc, step)
    b = dc.host_batch
    labels = rng.integers(0, num_classes, size=(b,))
    base = rng.standard_normal((b, image_size, image_size, 3)).astype(np.float32)
    # plant a label-dependent low-frequency pattern
    yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size), indexing="ij")
    for i, lab in enumerate(labels):
        base[i] += 0.5 * np.sin(
            2 * np.pi * (lab + 1) * (yy + xx) / (2 * image_size)
        )[..., None].astype(np.float32)
    return {"images": base, "labels": labels.astype(np.int32)}


class PrefetchIterator:
    """Background-thread double buffering (host-side pipeline overlap)."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
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
        self._thread.join(timeout=2)


def lm_pipeline(dc: DataConfig, start_step: int = 0) -> PrefetchIterator:
    return PrefetchIterator(lambda s: synth_lm_batch(dc, s), start_step)


def image_pipeline(dc: DataConfig, image_size: int, num_classes: int,
                   start_step: int = 0) -> PrefetchIterator:
    return PrefetchIterator(
        lambda s: synth_image_batch(dc, s, image_size=image_size,
                                    num_classes=num_classes),
        start_step,
    )
