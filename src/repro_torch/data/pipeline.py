"""``repro_torch/data/pipeline.py`` ↔ ``repro/data/pipeline.py``: a verbatim
copy (pure numpy), so the port makes its batches without importing ``repro``;
both draw from ``np.random.Philox``, so a batch is the reference's bit for bit.

Deterministic, resumable, shardable data pipeline.

Design requirements at 1000+ node scale:

  * **Deterministic**: batch ``t`` is a pure function of ``(seed, t)`` — any
    host can (re)compute any microbatch, which is what makes checkpoint
    restart and straggler/failure replay trivial (no data-state to persist
    beyond the integer step).
  * **Shardable**: each data-parallel replica deterministically slices its
    rows out of the global batch — the same global batch is formed no matter
    how many hosts participate, so elastic re-scaling is data-transparent.
  * **Stateless resume**: ``state = step`` — stored in the checkpoint
    manifest.

For LM training we synthesize token streams (no real corpus in the
container) with a fixed-vocab mixture process that has enough structure for
loss to fall; for VDT experiments the pipeline serves feature rows.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TokenPipeline", "FeaturePipeline"]


def _rng_for_step(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Synthetic LM token stream: order-2 Markov mixture over a fixed vocab.

    ``global_batch`` rows of ``seq_len + 1`` tokens; row r of batch t is a
    pure function of (seed, t, r).  ``shard(host, n_hosts)`` views the same
    global stream.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_modes: int = 64

    def batch(self, step: int, host: int = 0, n_hosts: int = 1) -> np.ndarray:
        assert self.global_batch % n_hosts == 0
        per = self.global_batch // n_hosts
        rng = _rng_for_step(self.seed, step * 1_000_003 + host)
        mode = rng.integers(0, self.n_modes, size=(per, 1))
        base = rng.integers(0, self.vocab_size, size=(per, self.seq_len + 1))
        # impose local structure: each mode biases toward a band of tokens
        band = (mode * (self.vocab_size // max(self.n_modes, 1))) % self.vocab_size
        width = max(self.vocab_size // 16, 2)
        biased = band + rng.integers(0, width, size=(per, self.seq_len + 1))
        pick = rng.random(size=(per, self.seq_len + 1)) < 0.8
        toks = np.where(pick, biased % self.vocab_size, base)
        return toks.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class FeaturePipeline:
    """Streaming feature rows for VDT-scale experiments (blocks of rows)."""

    n_total: int
    dim: int
    seed: int = 0
    n_classes: int = 2

    def block(self, start: int, count: int) -> tuple[np.ndarray, np.ndarray]:
        rng = _rng_for_step(self.seed, start)
        labels = rng.integers(0, self.n_classes, size=count)
        centers = np.random.RandomState(self.seed).randn(self.n_classes, self.dim) * 5
        x = centers[labels] + rng.normal(size=(count, self.dim))
        return x.astype(np.float32), labels.astype(np.int64)
