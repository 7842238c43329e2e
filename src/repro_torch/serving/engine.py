"""Static-batching serving engine (``repro.serving.engine``): requests are
grouped by (prompt length, max_new) into fixed-size batches, and each batch
runs as one speculative (or autoregressive) generation."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import SDStats
from ..core.speculative import (SDConfig, autoregressive_generate,
                                speculative_generate)
from ..models.model import Model


@dataclass
class Request:
    prompt: np.ndarray                 # (S,) int
    max_new_tokens: int = 32
    request_id: int = 0


@dataclass
class Result:
    request_id: int
    tokens: np.ndarray                 # generated continuation (max_new,)
    tau: float
    wall_time_s: float


@dataclass
class ServingEngine:
    target: Model
    target_params: object
    draft: Optional[Model] = None
    draft_params: object = None
    sd: SDConfig = field(default_factory=SDConfig)
    batch_size: int = 8

    @property
    def speculative(self) -> bool:
        return self.draft is not None

    def _run_batch(self, prompts: np.ndarray, max_new: int, gen):
        prompts = torch.as_tensor(prompts, dtype=torch.long,
                                  device=self.target.device)
        if self.speculative:
            toks, stats = speculative_generate(
                self.draft, self.target, self.draft_params, self.target_params,
                prompts, max_new, self.sd, gen=gen)
            return toks.cpu().numpy(), stats
        toks, dt = autoregressive_generate(
            self.target, self.target_params, prompts, max_new,
            temperature=self.sd.temperature, top_p=self.sd.top_p, gen=gen)
        n = int(prompts.shape[0]) * max_new
        return toks.cpu().numpy(), SDStats(total_tokens=n, num_blocks=n,
                                           wall_time_s=dt)

    def serve(self, requests: Sequence[Request], gen=None) -> List[Result]:
        if gen is None:
            gen = torch.Generator(device=self.target.device).manual_seed(0)
        by_len = {}
        for r in requests:
            by_len.setdefault((len(r.prompt), r.max_new_tokens), []).append(r)
        results: List[Result] = []
        for (plen, max_new), group in sorted(by_len.items()):
            for i in range(0, len(group), self.batch_size):
                batch = group[i:i + self.batch_size]
                prompts = np.stack([r.prompt for r in batch])
                t0 = time.perf_counter()
                toks, stats = self._run_batch(prompts, max_new, gen)
                dt = time.perf_counter() - t0
                for j, r in enumerate(batch):
                    results.append(Result(
                        request_id=r.request_id,
                        tokens=toks[j, plen:plen + max_new],
                        tau=stats.tau, wall_time_s=dt / len(batch)))
        return results
