"""Low-overhead span tracer exporting Chrome/Perfetto trace-event JSON (a
copy of ``repro.obs.trace``, which imports no JAX).

Two kinds of track:

  thread spans  — ``tracer.span("decode_round")`` context managers on the
                  engine thread (ph "X" complete events). Nesting is implied
                  by containment, the trace-event convention.
  request spans — one async track per request id (``async_begin`` /
                  ``async_instant`` / ``async_end``, ph "b"/"n"/"e"): the
                  per-request lifecycle submit -> admit -> first_token ->
                  retire, stamped with the *engine's own* latency clocks so
                  TTFT/TPOT reconstructed from the trace match
                  ``RequestStats`` exactly.
  counters      — ``tracer.counter("queue_depth", v)`` (ph "C"): queue depth,
                  active rows, free pages over time.

Overhead discipline: a disabled tracer (the default) returns a shared no-op
context manager from ``span()`` and falls through every other call after one
attribute check — no allocation, no clock read. Enabled spans append one
tuple per event to a plain list; JSON serialization happens only in
``write()``. All timestamps are ``time.perf_counter()`` seconds, exported as
microseconds relative to the first event (Perfetto-loadable via
``chrome://tracing`` or https://ui.perfetto.dev).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self.tracer, self.name, self.args = tracer, name, args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.tracer._events.append(
            ("X", self.name, self.t0, t1 - self.t0,
             threading.get_ident(), self.args))
        return False


class Tracer:
    """Event buffer + span factory. ``enabled=False`` is (near) free."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: list = []       # (ph, name, ts, dur/id, tid, args)

    # ------------------------------------------------------------- spans
    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, ts: Optional[float] = None, **args):
        if not self.enabled:
            return
        self._events.append(("i", name, ts if ts is not None
                             else time.perf_counter(), 0.0,
                             threading.get_ident(), args or None))

    # --------------------------------------------------- async (request) IDs
    def async_begin(self, name: str, aid: int, ts: Optional[float] = None,
                    **args):
        if not self.enabled:
            return
        self._events.append(("b", name, ts if ts is not None
                             else time.perf_counter(), aid, 0, args or None))

    def async_instant(self, name: str, aid: int, ts: Optional[float] = None,
                      **args):
        if not self.enabled:
            return
        self._events.append(("n", name, ts if ts is not None
                             else time.perf_counter(), aid, 0, args or None))

    def async_end(self, name: str, aid: int, ts: Optional[float] = None,
                  **args):
        if not self.enabled:
            return
        self._events.append(("e", name, ts if ts is not None
                             else time.perf_counter(), aid, 0, args or None))

    # ----------------------------------------------------------- counters
    def counter(self, name: str, value, ts: Optional[float] = None):
        if not self.enabled:
            return
        self._events.append(("C", name, ts if ts is not None
                             else time.perf_counter(), 0.0, 0,
                             {"value": float(value)}))

    # ------------------------------------------------------------- export
    def events(self) -> list:
        """Trace-event dicts (ts/dur in microseconds, relative origin)."""
        if not self._events:
            return []
        origin = min(e[2] for e in self._events)
        out = []
        for ph, name, ts, extra, tid, args in self._events:
            ev = {"ph": ph, "name": name, "pid": 1,
                  "ts": (ts - origin) * 1e6}
            if ph == "X":
                ev["tid"] = tid
                ev["dur"] = extra * 1e6
            elif ph in ("b", "n", "e"):
                # one async track per request id, grouped by category
                ev["tid"] = 0
                ev["cat"] = "request"
                ev["id"] = extra
            elif ph == "C":
                ev["tid"] = 0
            else:            # "i"
                ev["tid"] = tid
                ev["s"] = "t"
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return out

    def write(self, path: str):
        """Write Chrome trace-event JSON (object form, Perfetto-loadable)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, f)

    def clear(self):
        self._events.clear()


NULL_TRACER = Tracer(enabled=False)
_default: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install a process-default tracer (None -> disabled); returns it."""
    global _default
    _default = tracer if tracer is not None else NULL_TRACER
    return _default


def span(name: str, **args):
    """Module-level convenience: span on the process-default tracer."""
    return _default.span(name, **args)
