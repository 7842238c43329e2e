"""Batch-level dataset mixing (paper §2.3): each fine-tuning batch draws
``distill_mix`` (default 9:1) of its rows from the distillation dataset and
the rest from the pretraining dataset, for regularization."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def mixed_batches(distill: np.ndarray, pretrain: np.ndarray, batch_size: int,
                  mix: float = 0.9, seed: int = 0,
                  steps: int = 0) -> Iterator[np.ndarray]:
    """Yield (batch_size, S) batches; ``mix`` fraction of rows from distill."""
    rng = np.random.default_rng(seed)
    n_d = max(1, min(batch_size - 1, round(batch_size * mix))) \
        if len(pretrain) else batch_size
    n_p = batch_size - n_d
    i = 0
    while steps <= 0 or i < steps:
        di = rng.integers(len(distill), size=n_d)
        rows = [distill[di]]
        if n_p:
            pi = rng.integers(len(pretrain), size=n_p)
            rows.append(pretrain[pi])
        batch = np.concatenate(rows, axis=0)
        rng.shuffle(batch, axis=0)
        yield batch
        i += 1


def simple_batches(data: np.ndarray, batch_size: int, seed: int = 0,
                   steps: int = 0) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    i = 0
    while steps <= 0 or i < steps:
        idx = rng.integers(len(data), size=batch_size)
        yield data[idx]
        i += 1
