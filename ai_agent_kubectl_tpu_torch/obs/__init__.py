"""Observability: the JAX package's ``obs/`` for the port — request
tracing, the flight recorder and the telemetry plane.

The stdlib-only modules are copies of the JAX package's (the port
imports nothing of it); they are touched on the serving hot path and
from the batch scheduler thread.

- ``obs.trace`` — request ID + span API with monotonic timestamps; the
  active trace travels on a ``contextvars.ContextVar`` through the async
  serving path (middleware, cache, breaker, engine call, executor).
- ``obs.recorder`` — ring buffer of the last N finished request
  timelines (shed, rate-limited, degraded and failed ones included),
  served by ``/debug/requests[/{id}]``.
- ``obs.ledger`` — the goodput ledger: every device decode step a
  request cost, classified delivered or one of the waste classes per
  lane (and per hashed tenant behind ``/debug/ledger`` only), with a
  conservation invariant.
- ``obs.slo`` — multi-window error-budget burn rates for TTFT and queue
  wait per lane (``slo_*`` gauges, ``/health``'s ``slo`` section), the
  QoS brownout controller's burn input.
- ``obs.steptime`` — the step-time sentinel: per-(phase, bucket)
  digests of ms per device step, p50/p95/p99 gauges, breach detection
  against a ``PERF_BASELINES`` envelope or a self-calibrated one.
- ``obs.incidents`` — anomaly-triggered incident capture: a firing
  trigger assembles a bounded evidence bundle into the ring behind
  ``/debug/incidents``, with per-trigger cooldowns.

Two modules use torch and are imported by name, not from here:
``obs.profiler`` (``POST /debug/profile``'s capture on the engine's own
thread, and ``scope``, the forward's annotation helper) and
``obs.attribution`` (a capture → the ``decode-step-attribution/v2``
table; ``python -m ai_agent_kubectl_tpu_torch.obs.attribution``).
"""

from .incidents import TRIGGERS, IncidentManager, current_incident_id
from .ledger import (LEDGER_CLASSES, WASTE_CLASSES, GoodputLedger,
                     hash_tenant)
from .recorder import FlightRecorder
from .slo import SLO_QUEUE_WAIT, SLO_TTFT, SloEngine, parse_slo_windows
from .steptime import (PHASE_DECODE, PHASE_PREFILL, PHASE_SPEC_VERIFY,
                       STEP_PHASES, StepTimeSentinel, load_baselines,
                       prefill_bucket)
from .trace import (PHASES, Trace, current_trace, new_request_id,
                    sanitize_request_id, trace_event, use_trace)

__all__ = [
    "PHASES",
    "LEDGER_CLASSES",
    "WASTE_CLASSES",
    "PHASE_DECODE",
    "PHASE_PREFILL",
    "PHASE_SPEC_VERIFY",
    "SLO_QUEUE_WAIT",
    "SLO_TTFT",
    "STEP_PHASES",
    "TRIGGERS",
    "FlightRecorder",
    "GoodputLedger",
    "IncidentManager",
    "SloEngine",
    "StepTimeSentinel",
    "Trace",
    "current_incident_id",
    "current_trace",
    "hash_tenant",
    "load_baselines",
    "new_request_id",
    "parse_slo_windows",
    "prefill_bucket",
    "sanitize_request_id",
    "trace_event",
    "use_trace",
]
