"""Arrival-process generators for serving benchmarks (a copy of
``repro.traffic.arrivals``, which imports no JAX).

Two processes cover the traffic shapes that matter for a serving stack:

  poisson — memoryless (exponential inter-arrivals). The classic open-loop
            load model: arrivals are as smooth as random traffic gets, so
            queueing comes only from sustained rate vs capacity.
  gamma   — renewal process with Gamma inter-arrivals at the same mean rate
            but a chosen coefficient of variation. cv > 1 produces *bursts*
            (many arrivals back to back, then silence) without changing the
            long-run rate — exactly the pattern that exposes head-of-line
            blocking and priority starvation. cv = 1 recovers Poisson.

All generators return absolute arrival times in seconds (cumulative sums of
inter-arrival draws), monotone nondecreasing, starting after t=0.
"""
from __future__ import annotations

import numpy as np


def poisson_arrivals(rate_per_s: float, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """n arrival times of a Poisson process with the given mean rate."""
    if n <= 0:
        return np.zeros(0)
    if rate_per_s <= 0:
        return np.zeros(n)
    return np.cumsum(rng.exponential(1.0 / rate_per_s, n))


def gamma_arrivals(rate_per_s: float, n: int, rng: np.random.Generator,
                   cv: float = 3.0) -> np.ndarray:
    """n arrival times with Gamma inter-arrivals: mean 1/rate, given CV.

    Gamma(shape k, scale theta) has mean k*theta and CV 1/sqrt(k), so
    k = 1/cv^2 and theta = cv^2/rate. cv=1 is exactly exponential.
    """
    if n <= 0:
        return np.zeros(0)
    if rate_per_s <= 0:
        return np.zeros(n)
    if cv <= 0:
        raise ValueError("cv must be positive")
    shape = 1.0 / (cv * cv)
    scale = (cv * cv) / rate_per_s
    return np.cumsum(rng.gamma(shape, scale, n))


def arrival_times(process: str, rate_per_s: float, n: int,
                  rng: np.random.Generator, cv: float = 3.0) -> np.ndarray:
    """Dispatch on process name ("poisson" | "gamma")."""
    if process == "poisson":
        return poisson_arrivals(rate_per_s, n, rng)
    if process == "gamma":
        return gamma_arrivals(rate_per_s, n, rng, cv=cv)
    raise ValueError(f"unknown arrival process {process!r}")
