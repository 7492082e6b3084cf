"""Observability: request-lifecycle tracing and the flight recorder,
copied from the JAX package's ``obs/`` (stdlib only).

- ``obs.trace`` — request ID + span API with monotonic timestamps; the
  active trace travels on a ``contextvars.ContextVar`` through the async
  serving path (middleware, cache, breaker, engine call, executor).
- ``obs.recorder`` — ring buffer of the last N finished request
  timelines (shed, rate-limited, degraded and failed ones included).

The JAX package's profiler, goodput ledger, SLO burn rates, step-time
sentinel and incident capture wait for a later slice (ROADMAP.md A7).
"""

from .recorder import FlightRecorder
from .trace import (PHASES, Trace, current_trace, new_request_id,
                    sanitize_request_id, trace_event, use_trace)

__all__ = [
    "PHASES",
    "FlightRecorder",
    "Trace",
    "current_trace",
    "new_request_id",
    "sanitize_request_id",
    "trace_event",
    "use_trace",
]
