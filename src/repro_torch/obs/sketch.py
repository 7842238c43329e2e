"""Streaming quantile sketch + multi-window burn-rate SLO tracking (a copy
of ``repro.obs.sketch``, which imports no JAX).

``GKSketch`` is a Greenwald–Khanna epsilon-approximate quantile summary:
after ``n`` inserts, ``query(phi)`` returns a *stream element* whose rank in
the sorted stream is within ``eps * n`` of ``phi * n``, using
O((1/eps) log(eps n)) memory — a long serve run gets whole-run p50/p99
without retaining every latency sample (``core.metrics.latency_percentiles``
accepts a sketch in place of a list for exactly this). GK is chosen over P²
because it carries a *provable* rank-error bound, which is what the property
test in ``tests/test_quality_obs.py`` asserts against adversarial streams;
P² is heuristic and can be driven arbitrarily far off by sorted input.

``SLOTracker`` evaluates latency SLOs (TTFT / TPOT thresholds with a target
good-fraction) using the multi-window burn-rate rule: the *burn rate* is the
observed bad fraction over the error budget (1 - target), and an alert fires
only when BOTH a fast window and a slow window burn above their thresholds —
the fast window gives detection latency, the slow window immunity to blips
(the standard SRE multi-window multi-burn-rate alerting policy, applied at
request granularity since a serve run's natural clock is completions).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple


class GKSketch:
    """Greenwald–Khanna summary. Entries are ``[v, g, delta]`` sorted by v:
    ``g`` is the rank gap to the previous entry, ``delta`` the extra rank
    uncertainty, with the invariant ``g + delta <= 2 * eps * n`` maintained
    by ``_compress`` — which is what bounds the query's rank error."""

    def __init__(self, eps: float = 0.005):
        if not 0 < eps < 0.5:
            raise ValueError("eps must be in (0, 0.5)")
        self.eps = eps
        self.n = 0
        self._entries: List[list] = []        # [value, g, delta]
        self._gap = max(int(1.0 / (2.0 * eps)), 1)   # compress cadence

    def __len__(self) -> int:
        return len(self._entries)

    def insert(self, v: float):
        v = float(v)
        lo, hi = 0, len(self._entries)
        while lo < hi:                         # first entry with value >= v
            mid = (lo + hi) // 2
            if self._entries[mid][0] < v:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0 or lo == len(self._entries):
            delta = 0                          # new min/max: rank is exact
        else:
            delta = max(int(math.floor(2.0 * self.eps * self.n)) - 1, 0)
        self._entries.insert(lo, [v, 1, delta])
        self.n += 1
        if self.n % self._gap == 0:
            self._compress()

    def observe(self, v: float):               # registry-style alias
        self.insert(v)

    def _compress(self):
        cap = 2.0 * self.eps * self.n
        ent = self._entries
        i = len(ent) - 2
        while i >= 1:                          # keep the min entry intact
            if ent[i][1] + ent[i + 1][1] + ent[i + 1][2] <= cap:
                ent[i + 1][1] += ent[i][1]     # fold i into its successor
                del ent[i]
            i -= 1

    def query(self, phi: float) -> float:
        """Value of approximate rank ``ceil(phi * n)`` (phi in [0, 1])."""
        if self.n == 0:
            return float("nan")
        phi = min(max(phi, 0.0), 1.0)
        r = max(1, min(self.n, math.ceil(phi * self.n)))
        e = self.eps * self.n
        rmin = 0
        prev = self._entries[0][0]
        for v, g, d in self._entries:
            rmin += g
            if rmin + d > r + e:
                return prev
            prev = v
        return self._entries[-1][0]


# ------------------------------------------------------------------ SLO

@dataclass(frozen=True)
class SLOConfig:
    """One latency SLO: ``target`` of requests must land under the
    threshold; burn rate = bad fraction / (1 - target). The default burn
    thresholds follow the SRE fast/slow pairing (page on 14.4x over the
    short window only if the long window confirms at 6x)."""

    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    target: float = 0.99
    fast_window: int = 32                 # requests
    slow_window: int = 256
    fast_burn: float = 14.4
    slow_burn: float = 6.0

    @property
    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


class _WindowedBad:
    """Bounded window of good/bad observations with an O(1) bad count."""

    def __init__(self, window: int):
        self.ring: Deque[bool] = deque(maxlen=window)
        self.bad = 0

    def push(self, is_bad: bool):
        if len(self.ring) == self.ring.maxlen and self.ring[0]:
            self.bad -= 1
        self.ring.append(bool(is_bad))
        self.bad += int(is_bad)

    @property
    def frac(self) -> float:
        return self.bad / len(self.ring) if self.ring else 0.0


class SLOTracker:
    """Per-request SLO evaluation for the continuous engine.

    ``observe(ttft_s, tpot_s)`` returns the list of SLOs that *newly
    breached* on this observation (fast AND slow windows over their burn
    thresholds); ``breached`` stays latched for the post-mortem. Whole-run
    percentiles come from GK sketches, so memory is O(1) in requests."""

    def __init__(self, cfg: SLOConfig, sketch_eps: float = 0.005):
        self.cfg = cfg
        self.metrics: Dict[str, float] = {}
        if cfg.ttft_ms is not None:
            self.metrics["ttft"] = cfg.ttft_ms / 1e3
        if cfg.tpot_ms is not None:
            self.metrics["tpot"] = cfg.tpot_ms / 1e3
        self._fast = {m: _WindowedBad(cfg.fast_window) for m in self.metrics}
        self._slow = {m: _WindowedBad(cfg.slow_window) for m in self.metrics}
        self.sketches = {m: GKSketch(sketch_eps) for m in self.metrics}
        self.seen = 0
        self.bad_total = {m: 0 for m in self.metrics}
        self.breaches: Dict[str, int] = {m: 0 for m in self.metrics}

    @property
    def breached(self) -> bool:
        return any(v > 0 for v in self.breaches.values())

    def burn_rates(self, metric: str) -> Tuple[float, float]:
        b = self.cfg.budget
        return (self._fast[metric].frac / b, self._slow[metric].frac / b)

    def observe(self, ttft_s: float, tpot_s: float) -> List[str]:
        vals = {"ttft": ttft_s, "tpot": tpot_s}
        self.seen += 1
        fired = []
        for m, thresh in self.metrics.items():
            v = vals[m]
            bad = v > thresh
            self.bad_total[m] += int(bad)
            self.sketches[m].insert(v)
            self._fast[m].push(bad)
            self._slow[m].push(bad)
            fast, slow = self.burn_rates(m)
            if bad and fast >= self.cfg.fast_burn and slow >= self.cfg.slow_burn:
                self.breaches[m] += 1
                fired.append(m)
        return fired

    def summary(self) -> str:
        if not self.metrics:
            return "slo: no thresholds configured"
        parts = []
        for m, thresh in self.metrics.items():
            fast, slow = self.burn_rates(m)
            p99 = self.sketches[m].query(0.99) * 1e3
            parts.append(
                f"{m}<{thresh * 1e3:g}ms bad={self.bad_total[m]}/{self.seen}"
                f" burn(fast={fast:.1f},slow={slow:.1f})"
                f" p99={p99:.1f}ms breaches={self.breaches[m]}")
        return "slo: " + "  ".join(parts)

    def emit(self, registry):
        for m in self.metrics:
            fast, slow = self.burn_rates(m)
            registry.gauge(f"slo_{m}_burn_fast",
                           "fast-window burn rate").set(fast)
            registry.gauge(f"slo_{m}_burn_slow",
                           "slow-window burn rate").set(slow)
            registry.counter(f"slo_{m}_bad_total",
                             "requests over threshold").set_total(
                self.bad_total[m])
            registry.counter(f"slo_{m}_breaches_total",
                             "multi-window burn alerts").set_total(
                self.breaches[m])

    def snapshot(self) -> dict:
        """JSON-able state for the flight-recorder bundle."""
        out = {"seen": self.seen, "breaches": dict(self.breaches)}
        for m, thresh in self.metrics.items():
            fast, slow = self.burn_rates(m)
            out[m] = {"threshold_ms": thresh * 1e3,
                      "bad": self.bad_total[m],
                      "burn_fast": fast, "burn_slow": slow,
                      "p50_ms": self.sketches[m].query(0.5) * 1e3,
                      "p99_ms": self.sketches[m].query(0.99) * 1e3}
        return out
