"""Request traffic for the continuous engine: arrival processes and tenant
mixes (copies of ``repro.traffic``, which imports no JAX)."""
from .arrivals import (arrival_times, gamma_arrivals,      # noqa: F401
                       poisson_arrivals)
from .scenarios import (BURSTY_SHORT, LONG_CONTEXT_SUMMARIZE,  # noqa: F401
                        MIXES, SHARED_PREFIX_CHAT, Scenario,
                        TrafficMix, make_mix)
