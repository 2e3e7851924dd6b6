"""Restart-deterministic host data pipeline (``repro/data/pipeline.py``).

State = (seed, step).  Batch ``step`` is a pure function of the two, so a
checkpoint stores one integer and a restart resumes mid-stream exactly.
The port runs one process, so a batch is the whole global batch; batches
stay numpy arrays on the host, and the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


@dataclasses.dataclass
class DataPipeline:
    """An indexable batch function with a resumable step counter."""

    batch_fn: Callable[[int], Dict[str, np.ndarray]]  # step -> global batch
    step: int = 0

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch_fn(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self


def markov_batch_fn(vocab: int, batch: int, seq: int, *, seed: int = 0,
                    ) -> Callable[[int], Dict[str, np.ndarray]]:
    """Step-indexed Markov token batches ({"tokens", "labels"}, int32
    (batch, seq)): a Dirichlet transition table over the first
    min(vocab, 4096) ids, so cross-entropy has learnable signal."""
    base = np.random.default_rng(seed)
    v_eff = min(vocab, 4096)
    trans = base.dirichlet(np.full(64, 0.1), size=v_eff).astype(np.float32)
    targets = base.integers(0, v_eff, size=(v_eff, 64))

    def batch_fn(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, v_eff, size=batch)
        u = rng.random((batch, seq)).astype(np.float32)
        for t in range(seq):
            prev = toks[:, t]
            cdf = np.cumsum(trans[prev], axis=-1)
            pick = (u[:, t, None] < cdf).argmax(-1)
            toks[:, t + 1] = targets[prev, pick]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    return batch_fn
