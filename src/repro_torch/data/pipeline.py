"""Deterministic, resumable synthetic LM data, a numpy copy of
``repro/data/pipeline.py``.

Batch ``i`` is a pure function of (seed, i): a Zipfian unigram draw from
``np.random.default_rng((seed << 32) ^ i)`` with every odd position
continuing the even one before it by a fixed shift (a learnable bigram), so
a checkpointed cursor replays the stream exactly.  ``to_device`` takes the
place of ``make_global_batch``: one device, no mesh (the distributed slice
is later, ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "SyntheticCorpus", "to_device"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticCorpus:
    """Stateless counter-based batch source with a resumable cursor."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = (p / p.sum()).astype(np.float64)
        self._shift = 7919 % v  # prime shift induces learnable bigrams

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict) -> "SyntheticCorpus":
        if state["seed"] != cfg.seed:
            raise ValueError(f"data stream seed {state['seed']} != {cfg.seed} on restore")
        return cls(cfg, start_step=state["step"])

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step``: numpy tokens and labels (B, S) int32,
        mask (B, S) float32."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) ^ step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        base = rng.choice(v, size=(b, s + 1), p=self._probs)
        odd = np.arange(1, s + 1, 2)
        base[:, odd] = (base[:, odd - 1] + self._shift) % v
        return {"tokens": base[:, :-1].astype(np.int32),
                "labels": base[:, 1:].astype(np.int32),
                "mask": np.ones((b, s), np.float32)}

    def __next__(self) -> dict:
        out = self.batch_at(self.step)
        self.step += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def prefetching(self, depth: int = 2) -> Iterator[dict]:
        """Background-thread prefetch (host-side input pipeline overlap)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    q.put(next(self), timeout=0.5)
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def to_device(batch_np: dict, device=None) -> dict:
    """A host batch as tensors on ``device`` (CUDA unless given): tokens and
    labels int64 (torch's index type), mask float32."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(np.asarray(v))
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(dev, non_blocking=True)
    return out
