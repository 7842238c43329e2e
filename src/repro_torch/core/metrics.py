"""Speculative-decoding metrics (``repro.core.metrics``).

block efficiency tau : mean tokens committed per target-model run
                       (accepted drafts + 1), at most gamma + 1.
MBSU                 : memory-bound speed-up for relative draft cost
                       c = n_draft_params / n_target_params:
                       MBSU = tau / (c * gamma + 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


def mbsu(tau: float, c: float, gamma: int) -> float:
    return tau / (c * gamma + 1.0)


@dataclass
class SDStats:
    """Accumulated over a generation run. A block is one active row of one
    round: ``num_blocks`` sums the active rows over the ``rounds`` run.
    ``accept_hist[h]`` counts blocks that committed exactly h tokens;
    ``depth_hist[d]`` counts blocks that accepted a draft token at depth d
    (d = 1 is the first draft)."""

    total_tokens: int = 0
    num_blocks: int = 0
    rounds: int = 0
    accept_hist: Dict[int, int] = field(default_factory=dict)
    depth_hist: Dict[int, int] = field(default_factory=dict)
    wall_time_s: float = 0.0

    def update_batch(self, tokens_per_block):
        """One entry per active row of a batched round."""
        arr = np.asarray(tokens_per_block, dtype=np.int64)
        if arr.size == 0:
            return
        self.total_tokens += int(arr.sum())
        self.num_blocks += int(arr.size)
        vals, counts = np.unique(arr, return_counts=True)
        for v, c in zip(vals, counts):
            self.accept_hist[int(v)] = self.accept_hist.get(int(v), 0) + int(c)
        for d in range(1, int(arr.max())):
            n = int((arr - 1 >= d).sum())
            if n:
                self.depth_hist[d] = self.depth_hist.get(d, 0) + n

    def depth_acceptance(self) -> Dict[int, float]:
        """Fraction of blocks that accepted a draft token at each depth."""
        nb = max(self.num_blocks, 1)
        return {d: c / nb for d, c in sorted(self.depth_hist.items())}

    @property
    def tau(self) -> float:
        return self.total_tokens / max(self.num_blocks, 1)

    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_time_s, 1e-9)
