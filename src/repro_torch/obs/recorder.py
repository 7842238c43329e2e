"""Round-level flight recorder: bounded ring + post-mortem JSON bundle (a
copy of ``repro.obs.recorder``, which imports no JAX).

A serve run that fails (drafter drift alarm, SLO breach, crash) is only
debuggable if the moments *leading up to* the failure were retained — but a
production loop cannot afford to log every round forever. The recorder
keeps a bounded ring of the most recent per-round records (accept masks,
TVD summaries, scheduler/pool occupancy, phase times when enabled) at O(1)
memory, and ``dump()`` writes the whole ring plus caller-supplied context
snapshots as one self-contained JSON bundle when something trips.

Dump triggers are the caller's (the continuous engine dumps on drift alarm,
SLO breach, and crash); ``max_dumps`` bounds disk usage when an alarm
condition persists — after the cap, triggers are counted but not written.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional


def _jsonable(v):
    """Best-effort conversion of numpy scalars/arrays for json.dumps."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, float) and v != v:                   # NaN
        return None
    return v


class FlightRecorder:
    """Bounded ring of per-round records with triggered bundle dumps."""

    def __init__(self, out_dir: str = "flight", capacity: int = 256,
                 max_dumps: int = 8):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.out_dir = out_dir
        self.capacity = capacity
        self.max_dumps = max_dumps
        self.ring: Deque[dict] = deque(maxlen=capacity)
        self.rounds_seen = 0
        self.triggers: List[dict] = []
        self.dumped_paths: List[str] = []
        self._seq = 0

    def record_round(self, **fields):
        """Append one round record (oldest falls off past ``capacity``)."""
        self.rounds_seen += 1
        rec = {"round": self.rounds_seen}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self.ring.append(rec)

    def dump(self, reason: str, context: Optional[Dict] = None) -> Optional[str]:
        """Write the ring + context as one JSON bundle; returns the path
        (None once ``max_dumps`` bundles exist — the trigger is still
        recorded so the post-mortem knows the condition persisted)."""
        self.triggers.append({"reason": reason, "ts": time.time(),
                              "round": self.rounds_seen})
        if len(self.dumped_paths) >= self.max_dumps:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        self._seq += 1
        path = os.path.join(self.out_dir,
                            f"flight_{self._seq:03d}_{reason}.json")
        bundle = {"reason": reason,
                  "ts": time.time(),
                  "rounds_seen": self.rounds_seen,
                  "ring_capacity": self.capacity,
                  "triggers": list(self.triggers),
                  "context": _jsonable(context or {}),
                  "rounds": list(self.ring)}
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1)
            f.write("\n")
        self.dumped_paths.append(path)
        return path
