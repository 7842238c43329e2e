"""Distillation dataset generation (paper §2.2, ``repro.core.datagen``).

The target model (never the drafter) answers seed instructions under a
sweep of decoding configurations: temperatures {0, 0.3, 0.7, 1.0} with
top-p 0.95 (temperature 0 = greedy), so that the distillation data covers
the plausible target-generation distribution. Random draws come from one
``torch.Generator`` in place of the reference's JAX key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..models.model import Model
from .speculative import autoregressive_generate

PAPER_TEMPERATURES = (0.0, 0.3, 0.7, 1.0)
PAPER_TOP_P = 0.95


@dataclass(frozen=True)
class DatagenConfig:
    temperatures: Sequence[float] = PAPER_TEMPERATURES
    top_p: float = PAPER_TOP_P
    max_response_tokens: int = 64
    batch_size: int = 16


def generate_distillation_dataset(target: Model, t_params,
                                  seed_instructions: np.ndarray,
                                  cfg: DatagenConfig, gen=None) -> np.ndarray:
    """seed_instructions: (N, S_p) int -> (N * n_temps, S_p + max_resp)
    int32: each seed answered once per decoding configuration."""
    if gen is None:
        gen = torch.Generator(device=target.device).manual_seed(0)
    N = seed_instructions.shape[0]
    out: List[np.ndarray] = []
    for temp in cfg.temperatures:
        for i in range(0, N, cfg.batch_size):
            chunk = torch.as_tensor(seed_instructions[i:i + cfg.batch_size],
                                    dtype=torch.long, device=target.device)
            toks, _ = autoregressive_generate(
                target, t_params, chunk, cfg.max_response_tokens,
                temperature=float(temp), top_p=cfg.top_p, gen=gen)
            out.append(toks.cpu().numpy().astype(np.int32))
    return np.concatenate(out, axis=0)
