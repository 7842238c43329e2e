"""Observability of the serving path (``repro.obs``): span tracer, metrics
registry, phase timer and ``torch.profiler`` capture, roofline and
acceptance reports, speculation-quality statistics, SLO sketches and the
flight recorder. All of it is opt-in; nothing here runs unless a caller
builds it."""
from .trace import Tracer, NULL_TRACER, get_tracer, set_tracer, span  # noqa: F401
from .registry import (Counter, Gauge, Histogram,                     # noqa: F401
                       MetricsRegistry, log_buckets)
from .phases import PhaseTimer, torch_profile                         # noqa: F401
from .report import (acceptance_report, attribution_report,           # noqa: F401
                     format_acceptance_report, format_attribution)
from .quality import ENTROPY_BINS, PageHinkley, QualityStats          # noqa: F401
from .sketch import GKSketch, SLOConfig, SLOTracker                   # noqa: F401
from .recorder import FlightRecorder                                  # noqa: F401
