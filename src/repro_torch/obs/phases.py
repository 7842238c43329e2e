"""Phase-time attribution for the engine step loop (``repro.obs.phases``).

``PhaseTimer`` accumulates wall seconds per named phase (draft / verify /
commit / prefill) plus total step wall time; ``host`` is the residual —
everything the fenced phases don't cover (the engine's Python between
phases, scheduler work, host<->device transfers outside the fenced
regions), so the breakdown always sums to exactly the measured step time.

Attribution is only meaningful with *fences*: the engine's phased decode
path records a CUDA event at the end of each of draft / verify / commit and
synchronizes on it, which serializes dispatch and perturbs the overlap of
host and card. That is why ``time_phases`` is opt-in and OFF by default —
an untimed run pays none of it. On a host-bound eager engine a phase's
wall time includes the host's dispatch of that phase's ops.

``torch_profile(dir)`` is the escape hatch when fence-perturbed numbers
are not enough: a context manager around ``torch.profiler`` (CPU and, on
the card, CUDA activities) that exports the wrapped region's Chrome trace
into ``dir``; a no-op when ``dir`` is falsy.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

TRACE_FILE = "torch_trace.json"


class PhaseTimer:
    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.total_s = 0.0
        self.steps = 0

    def add(self, phase: str, dt: float):
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        self.counts[phase] = self.counts.get(phase, 0) + 1

    def add_step(self, dt: float):
        self.total_s += dt
        self.steps += 1

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    @property
    def host_s(self) -> float:
        """Residual step time not attributed to any fenced phase."""
        return max(self.total_s - sum(self.seconds.values()), 0.0)

    def breakdown(self) -> Dict[str, float]:
        """Phase -> seconds, with the ``host`` residual appended; sums to
        ``total_s`` by construction."""
        out = dict(sorted(self.seconds.items(), key=lambda kv: -kv[1]))
        out["host"] = self.host_s
        return out

    def fractions(self) -> Dict[str, float]:
        t = max(self.total_s, 1e-12)
        return {k: v / t for k, v in self.breakdown().items()}

    def summary(self) -> str:
        if self.total_s <= 0:
            return "phase timing: no steps recorded"
        parts = [f"{k}={v:.3f}s ({v / self.total_s:4.0%})"
                 for k, v in self.breakdown().items()]
        return (f"phase time over {self.steps} steps, "
                f"{self.total_s:.3f}s total: " + " ".join(parts))


@contextmanager
def torch_profile(trace_dir: Optional[str]):
    """Profile the wrapped region with ``torch.profiler`` and export its
    Chrome trace to ``trace_dir/torch_trace.json`` (also when the region
    raises). CPU activity always, CUDA activity when a card is present.

    No-op when ``trace_dir`` is falsy. A profiler that cannot start raises:
    a run that asked for a trace does not end without one."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
