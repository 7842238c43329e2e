"""Speculation-quality analytics: online TVD/acceptance curves + drift (a
copy of ``repro.obs.quality``, which imports numpy and no JAX).

The paper's thesis is that drafter quality — total variation distance
between the draft and target distributions — is what determines block
efficiency, yet the serving stack only ever observed the *outcome*
(accept/reject counts in ``SDStats``) and threw away the per-position
distributions the verify pass already computes. With ``SDConfig.quality``
on, the rounds leave a small per-row buffer in the round state
(``state["qual"]``: per-draft-depth empirical TVD ``0.5 * sum|p - q|``,
target entropy, and accept indicators) that the engine fetches in the
SAME per-round device-to-host copy it already makes — no extra host syncs, and
bit-identical tokens (the buffer is a pure function of p/q/n_acc; it
consumes no randomness and perturbs no sampling).

``QualityStats`` pools those buffers into:

  per-depth TVD / acceptance   — where along the chain (or tree path) does
                                 alignment decay? The live version of the
                                 paper's Figure-style depth analysis, and
                                 the input the ROADMAP's adaptive
                                 speculation controller needs.
  acceptance-vs-entropy curve  — acceptance binned by target entropy at the
                                 position: a drafter that only fails on
                                 high-entropy positions is aligned; one that
                                 fails on low-entropy positions is broken.
  drafter health               — EWMA acceptance plus a Page–Hinkley change
                                 detector on the per-round acceptance
                                 fraction: a drifting/degraded drafter
                                 (stale weights, bad quant reload, workload
                                 shift) raises an alarm the engine turns
                                 into a flight-recorder dump.

Acceptance counting distinguishes *attempted* positions (depth d is
attempted iff every shallower draft was accepted — chain rejection never
evaluates deeper positions) from drafted positions: acceptance curves
condition on attempted, TVD pools every drafted position (alignment is a
distribution property, measured whether or not the sample survived).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# target-entropy bin upper edges (nats) for the acceptance-vs-entropy curve;
# one-hot (temp 0) positions land in the first bin, ~uniform tails in the last
ENTROPY_BINS = (0.05, 0.5, 1.0, 2.0, 4.0, float("inf"))


class PageHinkley:
    """Page–Hinkley test for a downward mean shift in a bounded stream.

    Maintains the cumulative sum of ``x_t - mean_t + delta`` (drifts upward
    by ``delta`` per step while the stream is stationary); an alarm fires
    when the drawdown from the running maximum exceeds ``lam``. ``delta``
    absorbs noise (bigger = less sensitive), ``lam`` sets the magnitude x
    duration of a drop that alarms. Defaults are tuned for per-round
    acceptance *fractions* (pooled over a batch, so variance is small):
    a sustained drop of ~0.25 trips in a handful of rounds, stationary
    binomial noise does not trip over hundreds (bounded by the FP test in
    tests/test_quality_obs.py).
    """

    def __init__(self, delta: float = 0.05, lam: float = 1.0,
                 min_samples: int = 8):
        self.delta, self.lam, self.min_samples = delta, lam, min_samples
        self.n = 0
        self.mean = 0.0
        self.cum = 0.0
        self.cum_max = 0.0
        self.alarms = 0

    def update(self, x: float) -> bool:
        """Feed one observation; True iff the detector alarms on it."""
        x = float(x)
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self.cum += x - self.mean + self.delta
        self.cum_max = max(self.cum_max, self.cum)
        if self.n >= self.min_samples and \
                self.cum_max - self.cum > self.lam:
            self.alarms += 1
            self.reset_after_alarm()
            return True
        return False

    def reset_after_alarm(self):
        """Re-arm: drop the drawdown state but keep the alarm count (the
        post-drop mean becomes the new baseline, so a *recovery* back up is
        not an alarm and a second independent drop can still fire)."""
        self.n = 0
        self.mean = 0.0
        self.cum = 0.0
        self.cum_max = 0.0

    @property
    def drawdown(self) -> float:
        return self.cum_max - self.cum


@dataclass
class QualityStats:
    """Pooled quality accumulators over rounds (one per request, tenant,
    and engine in the continuous engine; ``merge`` folds them exactly)."""

    depth: int = 0                       # draft positions per round (gamma/D)
    ewma_alpha: float = 0.05
    ph: PageHinkley = field(default_factory=PageHinkley)
    rounds: int = 0
    # per-depth accumulators, length ``depth``
    tvd_sum: np.ndarray = field(default=None)
    ent_sum: np.ndarray = field(default=None)
    drafted: np.ndarray = field(default=None)      # positions drafted
    attempted: np.ndarray = field(default=None)    # positions reached
    accepted: np.ndarray = field(default=None)     # positions accepted
    # acceptance-vs-entropy curve (acceptance over attempted positions;
    # TVD over all drafted positions in the bin)
    ent_bin_drafted: np.ndarray = field(default=None)
    ent_bin_attempted: np.ndarray = field(default=None)
    ent_bin_accepted: np.ndarray = field(default=None)
    ent_bin_tvd_sum: np.ndarray = field(default=None)
    ewma_accept: float = float("nan")
    drift_alarms: int = 0
    last_alarm_round: int = -1

    def __post_init__(self):
        K, nb = self.depth, len(ENTROPY_BINS)
        if self.tvd_sum is None:
            self.tvd_sum = np.zeros(K)
            self.ent_sum = np.zeros(K)
            self.drafted = np.zeros(K, np.int64)
            self.attempted = np.zeros(K, np.int64)
            self.accepted = np.zeros(K, np.int64)
            self.ent_bin_drafted = np.zeros(nb, np.int64)
            self.ent_bin_attempted = np.zeros(nb, np.int64)
            self.ent_bin_accepted = np.zeros(nb, np.int64)
            self.ent_bin_tvd_sum = np.zeros(nb)

    # ------------------------------------------------------------- updates
    def update_round(self, tvd, ent, acc, drafted=None) -> bool:
        """Fold one round's device buffers for one or more rows.

        tvd/ent: (R, K) float — per-draft-depth TVD and target entropy;
        acc: (R, K) bool — depth accepted (equivalently ``d < n_acc``);
        drafted: (R, K) bool — depth actually drafted (chain rounds draft
        every depth; a tree round's committed path stops at its first
        rejection, so deeper entries carry no distribution). Defaults to
        all-True. Returns True iff the drift detector alarms on this round.
        """
        tvd = np.atleast_2d(np.asarray(tvd, np.float64))
        ent = np.atleast_2d(np.asarray(ent, np.float64))
        acc = np.atleast_2d(np.asarray(acc, bool))
        R, K = acc.shape
        if K != self.depth or R == 0:
            if K != self.depth:
                raise ValueError(f"round depth {K} != stats depth {self.depth}")
            return False
        if drafted is None:
            drafted = np.ones((R, K), bool)
        else:
            drafted = np.atleast_2d(np.asarray(drafted, bool))
        self.rounds += 1
        if K == 0:
            return False
        # depth d attempted iff all shallower depths accepted (prepend True);
        # attempted implies drafted in both round shapes
        att = np.concatenate(
            [np.ones((R, 1), bool), np.cumprod(acc[:, :-1], 1).astype(bool)], 1)
        att &= drafted
        self.tvd_sum += np.where(drafted, tvd, 0.0).sum(0)
        self.ent_sum += np.where(drafted, ent, 0.0).sum(0)
        self.drafted += drafted.sum(0)
        self.attempted += att.sum(0)
        self.accepted += (acc & att).sum(0)
        bins = np.searchsorted(ENTROPY_BINS, ent, side="left")
        np.add.at(self.ent_bin_drafted, bins[drafted], 1)
        np.add.at(self.ent_bin_tvd_sum, bins[drafted], tvd[drafted])
        np.add.at(self.ent_bin_attempted, bins[att], 1)
        np.add.at(self.ent_bin_accepted, bins[att & acc], 1)
        # round acceptance fraction -> EWMA + Page–Hinkley drafter health
        n_att = att.sum()
        if n_att == 0:
            return False
        frac = (acc & att).sum() / n_att
        if np.isnan(self.ewma_accept):
            self.ewma_accept = float(frac)
        else:
            self.ewma_accept += self.ewma_alpha * (float(frac) - self.ewma_accept)
        alarm = self.ph.update(float(frac))
        if alarm:
            self.drift_alarms += 1
            self.last_alarm_round = self.rounds
        return alarm

    def merge(self, other: "QualityStats") -> "QualityStats":
        """Fold another accumulator's counters (drift state is NOT merged —
        detectors are stream-local; alarm counts add)."""
        if other.depth != self.depth:
            raise ValueError("cannot merge QualityStats of different depths")
        self.rounds += other.rounds
        self.tvd_sum += other.tvd_sum
        self.ent_sum += other.ent_sum
        self.drafted += other.drafted
        self.attempted += other.attempted
        self.accepted += other.accepted
        self.ent_bin_drafted += other.ent_bin_drafted
        self.ent_bin_attempted += other.ent_bin_attempted
        self.ent_bin_accepted += other.ent_bin_accepted
        self.ent_bin_tvd_sum += other.ent_bin_tvd_sum
        self.drift_alarms += other.drift_alarms
        return self

    # ------------------------------------------------------------- queries
    def depth_tvd(self) -> Dict[int, float]:
        """Mean empirical TVD per draft depth (1-indexed like depth_hist)."""
        return {d + 1: float(self.tvd_sum[d] / self.drafted[d])
                for d in range(self.depth) if self.drafted[d]}

    def depth_acceptance(self) -> Dict[int, float]:
        """Conditional acceptance per depth: accepted / attempted."""
        return {d + 1: float(self.accepted[d] / self.attempted[d])
                for d in range(self.depth) if self.attempted[d]}

    def acceptance_entropy_curve(self):
        """Rows ``(ent_hi, attempted, accept_rate, mean_tvd)`` per non-empty
        target-entropy bin — acceptance conditioned on attempted positions,
        TVD averaged over every drafted position in the bin."""
        out = []
        for b in range(len(ENTROPY_BINS)):
            n = int(self.ent_bin_drafted[b])
            if n == 0:
                continue
            att = int(self.ent_bin_attempted[b])
            rate = (self.ent_bin_accepted[b] / att) if att else float("nan")
            out.append((ENTROPY_BINS[b], att, float(rate),
                        float(self.ent_bin_tvd_sum[b] / n)))
        return out

    @property
    def accept_rate(self) -> float:
        a = self.attempted.sum()
        return float(self.accepted.sum() / a) if a else float("nan")

    @property
    def mean_tvd(self) -> float:
        d = self.drafted.sum()
        return float(self.tvd_sum.sum() / d) if d else float("nan")

    @property
    def mean_entropy(self) -> float:
        d = self.drafted.sum()
        return float(self.ent_sum.sum() / d) if d else float("nan")

    @property
    def healthy(self) -> bool:
        return self.drift_alarms == 0

    def summary(self) -> str:
        if self.rounds == 0:
            return "quality: no rounds observed"
        da = " ".join(f"d{d}={r:.2f}" for d, r in self.depth_acceptance().items())
        dt = " ".join(f"d{d}={t:.3f}" for d, t in self.depth_tvd().items())
        return (f"quality over {self.rounds} rounds: "
                f"accept={self.accept_rate:.3f} (ewma {self.ewma_accept:.3f}) "
                f"mean_tvd={self.mean_tvd:.3f} "
                f"drift_alarms={self.drift_alarms}\n"
                f"  per-depth acceptance: {da or 'none'}\n"
                f"  per-depth TVD: {dt or 'none'}")

    def emit(self, registry, prefix: str = "quality"):
        """Publish onto the shared metrics surface (obs.registry)."""
        registry.gauge(f"{prefix}_accept_ewma",
                       "EWMA per-round acceptance fraction").set(
            0.0 if np.isnan(self.ewma_accept) else self.ewma_accept)
        registry.gauge(f"{prefix}_mean_tvd",
                       "mean draft-target TVD per drafted position").set(
            0.0 if np.isnan(self.mean_tvd) else self.mean_tvd)
        registry.counter(f"{prefix}_rounds_total",
                         "rounds pooled").set_total(self.rounds)
        registry.counter(f"{prefix}_drift_alarms_total",
                         "Page-Hinkley drafter-drift alarms").set_total(
            self.drift_alarms)
        registry.gauge(f"{prefix}_drift_drawdown",
                       "Page-Hinkley drawdown vs alarm threshold").set(
            self.ph.drawdown)

    def snapshot(self) -> dict:
        """JSON-able state for the flight-recorder bundle."""
        return {"rounds": self.rounds,
                "accept_rate": self.accept_rate,
                "ewma_accept": self.ewma_accept,
                "mean_tvd": self.mean_tvd,
                "depth_acceptance": self.depth_acceptance(),
                "depth_tvd": self.depth_tvd(),
                "drift_alarms": self.drift_alarms,
                "last_alarm_round": self.last_alarm_round,
                "ph_drawdown": self.ph.drawdown,
                "entropy_curve": [
                    {"ent_hi": hi if np.isfinite(hi) else "inf",
                     "attempted": att, "accept_rate": rate, "mean_tvd": tv}
                    for hi, att, rate, tv in self.acceptance_entropy_curve()]}
