"""Speculative-decoding and serving metrics (``repro.core.metrics``).

block efficiency tau : mean tokens committed per target-model run
                       (accepted drafts + 1), at most gamma + 1.
MBSU                 : memory-bound speed-up for relative draft cost
                       c = n_draft_params / n_target_params:
                       MBSU = tau / (c * gamma + 1).
token-rate ratio     : measured SD tokens/sec over autoregressive tokens/sec.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

import numpy as np


def block_efficiency(total_tokens: float, num_blocks: float) -> float:
    return total_tokens / max(num_blocks, 1.0)


def mbsu(tau: float, c: float, gamma: int) -> float:
    return tau / (c * gamma + 1.0)


def token_rate_ratio(sd_tokens_per_s: float, ar_tokens_per_s: float) -> float:
    return sd_tokens_per_s / max(ar_tokens_per_s, 1e-12)


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

    def update(self, tokens_this_block: int):
        """One block (one row of one round) that committed that many."""
        self.update_batch([tokens_this_block])

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

    def merge(self, other: "SDStats") -> "SDStats":
        """Fold another run's counters into this one (in place)."""
        self.total_tokens += other.total_tokens
        self.num_blocks += other.num_blocks
        self.rounds += other.rounds
        for h, c in other.accept_hist.items():
            self.accept_hist[h] = self.accept_hist.get(h, 0) + c
        for d, c in other.depth_hist.items():
            self.depth_hist[d] = self.depth_hist.get(d, 0) + c
        self.wall_time_s += other.wall_time_s
        return self

    @property
    def tau(self) -> float:
        return block_efficiency(self.total_tokens, self.num_blocks)

    def mbsu(self, c: float, gamma: int) -> float:
        return mbsu(self.tau, c, gamma)

    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_time_s, 1e-9)

    def emit(self, registry, prefix: str = "sd"):
        """Publish the accumulated counters into a metrics registry
        (obs.registry) as monotonic totals — the stats object stays the
        source of truth; the registry is the exposition surface."""
        registry.counter(f"{prefix}_tokens_total",
                         "committed tokens").set_total(self.total_tokens)
        registry.counter(f"{prefix}_blocks_total",
                         "speculation rounds").set_total(self.num_blocks)
        registry.gauge(f"{prefix}_tau", "block efficiency").set(
            self.tau if self.num_blocks else 0.0)
        for h, c in sorted(self.accept_hist.items()):
            registry.counter(f"{prefix}_blocks_committed_{h}_total",
                             f"rounds committing exactly {h} tokens"
                             ).set_total(c)


# --------------------------------------------------------- serving telemetry

def latency_percentiles(values_s, qs=(50, 99)) -> Dict[str, float]:
    """{"p50_ms": ..., "p99_ms": ...} over second-valued latencies.

    Benchmarks report p50 *and* p99 rather than means: tail latency is what
    an SLO buys, and means hide exactly the head-of-line effects (prefill
    stalls, bursty arrivals) the serving stack exists to bound.

    Empty input returns NaN, not 0.0 — a run that completed zero requests
    has no latency, and a fake 0 ms p99 both reads as an impossibly good
    result and poisons benchmark trajectory comparison (bench_persist skips
    NaN-valued metrics instead of flagging a regression against 0).

    Accepts either an iterable of latencies or a streaming quantile sketch
    (anything with a ``query(phi)`` method) so long-running serve loops
    don't have to retain every sample."""
    if hasattr(values_s, "query"):
        if len(values_s) == 0:
            return {f"p{q}_ms": float("nan") for q in qs}
        return {f"p{q}_ms": float(values_s.query(q / 100.0) * 1e3) for q in qs}
    vals = np.asarray(list(values_s), dtype=np.float64)
    if vals.size == 0:
        return {f"p{q}_ms": float("nan") for q in qs}
    return {f"p{q}_ms": float(np.percentile(vals, q) * 1e3) for q in qs}


@dataclass
class RequestStats:
    """Per-request latency/efficiency record for the continuous engine.

    TTFT counts submit -> first generated token available (prefill done +
    pending sampled); TPOT is decode time per token after the first.
    ``prefix_hit_tokens`` counts prompt tokens served from the prefix cache
    (skipped by chunked prefill) when sharing is enabled.
    """

    request_id: int
    submit_time_s: float = 0.0
    admit_time_s: float = 0.0
    first_token_time_s: float = 0.0
    finish_time_s: float = 0.0
    prompt_tokens: int = 0
    new_tokens: int = 0
    prefix_hit_tokens: int = 0
    sd: SDStats = field(default_factory=SDStats)
    # obs.quality.QualityStats when the engine runs with quality telemetry
    # on (kept as object: core does not import obs)
    quality: Optional[object] = None

    @property
    def ttft_s(self) -> float:
        return max(self.first_token_time_s - self.submit_time_s, 0.0)

    @property
    def tpot_s(self) -> float:
        decode = max(self.finish_time_s - self.first_token_time_s, 0.0)
        return decode / max(self.new_tokens - 1, 1)

    @property
    def queue_wait_s(self) -> float:
        return max(self.admit_time_s - self.submit_time_s, 0.0)

    @property
    def tau(self) -> float:
        return self.sd.tau


@dataclass
class ServingTelemetry:
    """Engine-level counters sampled once per scheduler step.

    Per-step series (queue depth, active rows, free pages, shared fraction)
    are kept in *bounded* rings of the most recent ``window`` samples — a
    long serve run's memory is O(window), not O(steps) — while the summary
    statistics (max queue depth, means) are maintained as exact running
    aggregates over EVERY sample ever taken, so nothing the serve summary
    reports degrades when the ring wraps.

    With a ``registry`` attached (obs.registry; the continuous engine passes
    its own) every sample also updates live gauges/counters, making the
    telemetry an *emitter* onto the shared metrics surface instead of a
    parallel store that needs scraping.
    """

    window: int = 1024
    registry: Optional[object] = None
    queue_depth: Deque[int] = field(init=False)
    active_rows: Deque[int] = field(init=False)
    free_pages: Deque[int] = field(init=False)
    shared_frac: Deque[float] = field(init=False)
    steps: int = 0
    decode_rounds: int = 0
    prefill_chunks: int = 0
    admitted: int = 0
    completed: int = 0

    def __post_init__(self):
        for name in ("queue_depth", "active_rows", "free_pages",
                     "shared_frac"):
            setattr(self, name, deque(maxlen=self.window))
        self._samples = 0
        self._max_queue = 0
        self._sum_active = 0.0
        self._sum_shared = 0.0

    def sample(self, queue_depth: int, active_rows: int, free_pages: int,
               shared_frac: float = 0.0):
        self.steps += 1
        self._samples += 1
        self.queue_depth.append(int(queue_depth))
        self.active_rows.append(int(active_rows))
        self.free_pages.append(int(free_pages))
        self.shared_frac.append(float(shared_frac))
        self._max_queue = max(self._max_queue, int(queue_depth))
        self._sum_active += active_rows
        self._sum_shared += shared_frac
        if self.registry is not None:
            r = self.registry
            r.gauge("serve_queue_depth", "arrived, unadmitted").set(queue_depth)
            r.gauge("serve_active_rows", "decode slots in use").set(active_rows)
            r.gauge("serve_free_pages", "KV pool free pages").set(free_pages)
            r.gauge("serve_shared_page_frac",
                    "live pages with >1 owner").set(shared_frac)
            self.emit(r)

    def emit(self, registry):
        """Publish the monotonic counters (steps/rounds/chunks/admissions)."""
        for name, help_, v in (
                ("serve_steps_total", "engine iterations", self.steps),
                ("serve_decode_rounds_total", "speculative rounds",
                 self.decode_rounds),
                ("serve_prefill_chunks_total", "prefill chunks fed",
                 self.prefill_chunks),
                ("serve_admitted_total", "requests admitted", self.admitted),
                ("serve_completed_total", "requests finished", self.completed)):
            registry.counter(name, help_).set_total(v)

    @property
    def max_queue_depth(self) -> int:
        return self._max_queue

    @property
    def mean_active_rows(self) -> float:
        return self._sum_active / self._samples if self._samples else 0.0

    @property
    def mean_shared_frac(self) -> float:
        """Mean fraction of live KV pages referenced by more than one owner
        (requests and/or the prefix cache) across sampled steps."""
        return self._sum_shared / self._samples if self._samples else 0.0


@dataclass
class PrefixCacheTelemetry:
    """Prefix-cache counters for the serve summary (serving.prefix_cache).

    ``lookups``/``hits`` count *admitted* requests (a blocked head probing
    repeatedly is one lookup once it lands); ``hit_tokens`` over
    ``prompt_tokens`` is the fraction of prefill work the cache absorbed.
    """

    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0
    prompt_tokens: int = 0
    pages_inserted: int = 0
    evictions: int = 0
    cow_copies: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    @property
    def tokens_saved_rate(self) -> float:
        """Fraction of prompt tokens whose prefill was skipped entirely."""
        return self.hit_tokens / max(self.prompt_tokens, 1)

    def summary(self) -> str:
        return (f"hit_rate={self.hit_rate:.2f} "
                f"prefill_tokens_saved={self.hit_tokens}"
                f"/{self.prompt_tokens} ({self.tokens_saved_rate:.2f}) "
                f"pages_inserted={self.pages_inserted} "
                f"evictions={self.evictions} cow_copies={self.cow_copies}")

    def emit(self, registry):
        """Publish prefix-cache counters into a metrics registry
        (obs.registry) as monotonic totals."""
        for name, help_, v in (
                ("prefix_lookups_total", "admitted-request probes",
                 self.lookups),
                ("prefix_hits_total", "probes with a nonzero hit", self.hits),
                ("prefix_hit_tokens_total", "prompt tokens served from cache",
                 self.hit_tokens),
                ("prefix_prompt_tokens_total", "prompt tokens submitted",
                 self.prompt_tokens),
                ("prefix_pages_inserted_total", "pages registered",
                 self.pages_inserted),
                ("prefix_evictions_total", "LRU leaf evictions",
                 self.evictions),
                ("prefix_cow_copies_total", "tail-page COW copies",
                 self.cow_copies)):
            registry.counter(name, help_).set_total(v)
        registry.gauge("prefix_hit_rate", "hits over lookups").set(
            self.hit_rate if self.lookups else 0.0)
