"""Admission-controlled request scheduler for the continuous engine (a copy
of ``repro.serving.scheduler``, which imports no JAX).

Policies:
  fcfs     — strict head-of-line order by (arrival_time, submit sequence).
             The head blocks admission until it fits (no starvation, no
             reordering; a huge request at the head *is allowed* to hold the
             line — the predictable behaviour a latency SLO wants).
  priority — lowest ``priority`` value first, ties FCFS. Still head-of-line
             within the sorted order. With ``aging_s`` set, a request's
             effective priority improves by one class per ``aging_s``
             seconds of queue wait: sustained high-priority arrivals can
             then delay low-priority work but never starve it (a request
             that has waited (p_low - p_high) * aging_s seconds outranks
             fresh arrivals of class p_high).

The scheduler also owns the *prefix probe*: when the engine runs a prefix
cache (serving.prefix_cache), admission stamps the head candidate's
``prefix_hit``/``prefix_pages`` before asking the engine whether it fits —
the hit shrinks both the chunked-prefill work and the number of fresh KV
pages the admission check must find.

Admission itself (does the request fit?) is the engine's call — it knows the
free decode slots and the KV pool state; the scheduler only owns ordering,
arrival gating, aging, and queue-depth accounting.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class ServeRequest:
    """One unit of work for the continuous engine."""

    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 32
    request_id: int = 0
    priority: int = 0                  # lower = more urgent (priority policy)
    arrival_time_s: float = 0.0        # relative to engine clock start
    on_token: Optional[Callable] = None    # callback(request_id, np.ndarray)
    on_finish: Optional[Callable] = None   # callback(Result)
    # tenant/traffic-scenario tag (traffic.Scenario.build stamps its name;
    # the reference pools speculation-quality stats per tenant, which the
    # port's engine does not yet). "" = untagged.
    tenant: str = ""
    # stamped by the scheduler's prefix probe at admission time (engine-owned
    # prefix cache): prompt tokens already resident in the KV pool, and the
    # physical pages backing them, mapped read-only into this request's table
    prefix_hit: int = 0
    prefix_pages: List[int] = field(default_factory=list)


class Scheduler:
    def __init__(self, policy: str = "fcfs", aging_s: Optional[float] = None,
                 prefix_probe: Optional[Callable] = None,
                 registry=None):
        if policy not in ("fcfs", "priority"):
            raise ValueError(f"unknown policy {policy!r}")
        if aging_s is not None and aging_s <= 0:
            raise ValueError("aging_s must be positive")
        self.policy = policy
        self.aging_s = aging_s         # priority policy only; None = no aging
        self.prefix_probe = prefix_probe
        self._queue: List[tuple] = []
        self._seq = itertools.count()
        # optional metrics-registry emitters: submissions and capacity-blocked
        # head pops (the queue-pressure signal the serve summary can't see)
        self._m_submitted = self._m_blocked = None
        if registry is not None:
            self._m_submitted = registry.counter(
                "sched_submitted_total", "requests submitted to the queue")
            self._m_blocked = registry.counter(
                "sched_blocked_pops_total",
                "admissible-head probes refused by capacity")

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, req: ServeRequest):
        if self._m_submitted is not None:
            self._m_submitted.inc()
        seq = next(self._seq)
        if self.policy == "priority":
            key = (req.priority, req.arrival_time_s, seq)
        else:
            key = (req.arrival_time_s, seq)
        self._queue.append((key, req))

    def ready_depth(self, now_s: float) -> int:
        """Number of queued requests that have already arrived."""
        return sum(1 for _, r in self._queue if r.arrival_time_s <= now_s)

    def _head(self, now_s: float) -> Optional[tuple]:
        """Best arrived entry under the policy (aging applied at read time —
        effective priority is a function of *now*, so it cannot live in a
        static heap key)."""
        arrived = [e for e in self._queue if e[1].arrival_time_s <= now_s]
        if not arrived:
            return None
        if self.policy == "priority" and self.aging_s is not None:
            def eff(entry):
                key, r = entry
                waited = max(now_s - r.arrival_time_s, 0.0)
                return (r.priority - waited / self.aging_s, key)
            return min(arrived, key=eff)
        return min(arrived, key=lambda e: e[0])

    def pop_admissible(self, now_s: float,
                       can_admit: Callable[[ServeRequest], bool]
                       ) -> Optional[ServeRequest]:
        """Head-of-line pop among *arrived* requests: return the best one the
        engine can admit, else None. A capacity-blocked head holds the line
        (no queue jumping within a policy class), but a request that has not
        arrived yet never blocks arrived work — a real scheduler has no
        knowledge of future arrivals."""
        head = self._head(now_s)
        if head is None:
            return None
        if self.prefix_probe is not None:
            # stamp prefix_hit/prefix_pages before the capacity check: a hit
            # needs fewer fresh pages, so it can admit into a fuller pool
            self.prefix_probe(head[1])
        if not can_admit(head[1]):
            if self._m_blocked is not None:
                self._m_blocked.inc()
            return None
        self._queue.remove(head)
        return head[1]
