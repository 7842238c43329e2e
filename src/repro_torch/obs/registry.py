"""Metrics registry: counters, gauges, fixed-bucket histograms (a copy of
``repro.obs.registry``, which imports no JAX).

One flat namespace of named series (no label dimensions — a serving process
has a fixed, small set of series; distinct phases/pools get distinct names).
Two export paths:

  Prometheus text exposition (``to_prometheus``) — the pull-scrape format,
  ``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket{le=...}`` histogram
  lines ending at ``+Inf``.
  JSONL snapshots (``write_snapshot``) — one self-contained JSON object per
  line appended to a file, for offline trajectory plots of a serve run.

Counters support both live increments (``inc``) and ``set_total`` for
retrofitting accumulated telemetry dataclasses (``SDStats`` /
``ServingTelemetry`` / ``PrefixCacheTelemetry`` re-publish their counts as
monotonic totals instead of keeping a second store in sync event-by-event).
"""
from __future__ import annotations

import json
import re
import time
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

DEFAULT_BUCKETS = (.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1., 2.5, 5.)


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n

    def set_total(self, total: float):
        """Publish an externally accumulated total (monotonic: never lowers)."""
        self.value = max(self.value, float(total))


class Gauge:
    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, n: float = 1.0):
        self.value += n


class Histogram:
    """Fixed upper-edge buckets plus the implicit +Inf bucket.

    ``counts[i]`` is the number of observations <= ``buckets[i]`` exclusive
    of earlier buckets (non-cumulative storage; exposition cumulates, per
    the Prometheus convention)."""

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 help: str = ""):
        edges = tuple(float(b) for b in buckets)
        # strictly-increasing, finite edges: an out-of-order or duplicated
        # edge would silently misroute observations (bisect assumes order),
        # and a non-finite edge shadows the implicit +Inf bucket
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if any(b != b or b in (float("inf"), float("-inf")) for b in edges):
            raise ValueError(f"histogram buckets must be finite "
                             f"(+Inf is implicit): {edges}")
        if any(b >= a for b, a in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram buckets must be strictly increasing: {edges}")
        self.name, self.help = name, help
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)       # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> Tuple[Tuple[float, int], ...]:
        """((upper_edge, cumulative_count), ...) ending at (inf, count)."""
        out, run = [], 0
        for edge, c in zip(self.buckets + (float("inf"),), self.counts):
            run += c
            out.append((edge, run))
        return tuple(out)


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    # ----------------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                for edge, cum in m.cumulative():
                    le = "+Inf" if edge == float("inf") else _fmt(edge)
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> dict:
        """One JSON-able dict of every series' current value."""
        out: dict = {}
        for name, m in self._metrics.items():
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            else:
                out[name] = {"sum": m.sum, "count": m.count,
                             "buckets": {_fmt(e): c for e, c
                                         in zip(m.buckets, m.counts)},
                             "inf": m.counts[-1]}
        return out

    def write_snapshot(self, path: str, ts: Optional[float] = None):
        """Append one snapshot line to a JSONL file."""
        rec = {"ts": time.time() if ts is None else ts,
               "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Log-spaced histogram bucket edges from ``lo`` to at least ``hi``.

    Latency distributions are heavy-tailed, so linear buckets either waste
    resolution on the head or clip the tail; log spacing covers decades at
    constant relative resolution (``per_decade`` edges each). Edges are
    rounded to 3 significant digits so expositions stay readable."""
    if not (0 < lo < hi):
        raise ValueError("need 0 < lo < hi")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    ratio = 10.0 ** (1.0 / per_decade)
    out, v = [], float(lo)
    while v < hi * (1 + 1e-9):
        out.append(float(f"{v:.3g}"))
        v *= ratio
    if out[-1] < hi:
        out.append(float(f"{hi:.3g}"))
    # rounding to 3 sig figs can collapse adjacent edges at coarse spacing
    dedup = [out[0]]
    for e in out[1:]:
        if e > dedup[-1]:
            dedup.append(e)
    return tuple(dedup)


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))
