"""Multi-tenant traffic scenarios for the continuous serving engine (a copy
of ``repro.traffic.scenarios``, which imports no JAX).

A ``Scenario`` describes one tenant's request population: prompt-length
range, how many leading tokens every request of the tenant shares (the
system prompt / few-shot preamble that makes prefix caching pay), output
budget, and the arrival process. A ``TrafficMix`` blends scenarios by
weight into one request stream, merged by arrival time — the workload the
serving benchmark and ``launch.serve --traffic-mix`` replay.

The shared prefix is drawn once per scenario from a seed derived from the
scenario name, so every request of that tenant opens with the *same*
tokens (and two runs of the same mix are identical). Prompt suffixes and
output lengths are i.i.d. per request. Shapes are tiny-model scale on
purpose — the benchmarks run the repro's 4-6-layer models; the *ratios*
(hit rate, prefill tokens saved, TTFT deltas) are the transferable signal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..serving.scheduler import ServeRequest
from .arrivals import arrival_times


@dataclass(frozen=True)
class Scenario:
    """One tenant's request population."""

    name: str
    prompt_lo: int                  # prompt length range [lo, hi)
    prompt_hi: int
    shared_prefix_len: int          # leading tokens common to all requests
    new_lo: int                     # max_new_tokens range [lo, hi)
    new_hi: int
    process: str = "poisson"        # arrival process (traffic.arrivals)
    cv: float = 1.0                 # burstiness (gamma only)
    priority: int = 0               # scheduler class (lower = more urgent)

    def prefix_tokens(self, vocab_size: int) -> np.ndarray:
        """The tenant's shared opening tokens (deterministic per scenario)."""
        rng = np.random.default_rng(abs(hash(self.name)) % (2 ** 31))
        return rng.integers(0, vocab_size,
                            self.shared_prefix_len).astype(np.int32)

    def build(self, n: int, rate_per_s: float, vocab_size: int,
              rng: np.random.Generator) -> List[ServeRequest]:
        """n requests of this tenant with arrivals at the given mean rate."""
        prefix = self.prefix_tokens(vocab_size)
        lens = rng.integers(self.prompt_lo, self.prompt_hi, n)
        news = rng.integers(self.new_lo, self.new_hi, n)
        at = arrival_times(self.process, rate_per_s, n, rng, cv=self.cv)
        out = []
        for i in range(n):
            L = max(int(lens[i]), self.shared_prefix_len + 1)
            suffix = rng.integers(0, vocab_size,
                                  L - len(prefix)).astype(np.int32)
            out.append(ServeRequest(
                prompt=np.concatenate([prefix, suffix]),
                max_new_tokens=int(news[i]), priority=self.priority,
                arrival_time_s=float(at[i]), tenant=self.name))
        return out


# Tenant archetypes (tiny-model scale; page_size 16 in the benchmarks, so
# the 40-token chat preamble caches as 2 full pages = 32 shared tokens).
SHARED_PREFIX_CHAT = Scenario(
    name="chat", prompt_lo=48, prompt_hi=65, shared_prefix_len=40,
    new_lo=8, new_hi=17, process="poisson")

LONG_CONTEXT_SUMMARIZE = Scenario(
    name="summarize", prompt_lo=96, prompt_hi=129, shared_prefix_len=0,
    new_lo=4, new_hi=9, process="poisson")

BURSTY_SHORT = Scenario(
    name="bursty", prompt_lo=8, prompt_hi=25, shared_prefix_len=0,
    new_lo=4, new_hi=13, process="gamma", cv=3.0)


@dataclass(frozen=True)
class TrafficMix:
    """Weighted blend of scenarios merged into one arrival-ordered stream."""

    name: str
    parts: Tuple[Tuple[Scenario, float], ...]

    def build(self, n_requests: int, rate_per_s: float, vocab_size: int,
              seed: int = 0) -> List[ServeRequest]:
        """n_requests split by weight; each tenant arrives at its weighted
        share of the total rate; the merged stream is re-numbered in arrival
        order (request_id = arrival rank)."""
        wsum = sum(w for _, w in self.parts)
        reqs: List[ServeRequest] = []
        rng = np.random.default_rng(seed)
        remaining = n_requests
        for j, (sc, w) in enumerate(self.parts):
            n = (remaining if j == len(self.parts) - 1
                 else int(round(n_requests * w / wsum)))
            n = min(n, remaining)
            remaining -= n
            reqs.extend(sc.build(n, rate_per_s * w / wsum, vocab_size, rng))
        reqs.sort(key=lambda r: r.arrival_time_s)
        for i, r in enumerate(reqs):
            r.request_id = i
        return reqs

    def scenarios(self) -> Sequence[Scenario]:
        return [sc for sc, _ in self.parts]


MIXES = {
    "chat": TrafficMix("chat", ((SHARED_PREFIX_CHAT, 1.0),)),
    "summarize": TrafficMix("summarize", ((LONG_CONTEXT_SUMMARIZE, 1.0),)),
    "bursty": TrafficMix("bursty", ((BURSTY_SHORT, 1.0),)),
    "mixed": TrafficMix("mixed", ((SHARED_PREFIX_CHAT, 0.5),
                                  (LONG_CONTEXT_SUMMARIZE, 0.25),
                                  (BURSTY_SHORT, 0.25))),
}


def make_mix(name: str) -> TrafficMix:
    if name not in MIXES:
        raise ValueError(f"unknown traffic mix {name!r}; "
                         f"choose from {sorted(MIXES)}")
    return MIXES[name]
