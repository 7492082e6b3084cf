"""Request/response schemas (reference app.py:153-174), pydantic v2.

The wire contract is kept byte-compatible with the reference:
``Query{query}``, ``ExecuteRequest{execute}``, ``CommandResponse{
kubectl_command, execution_result, execution_error, from_cache, metadata}``,
``ExecutionMetadata{start_time, end_time, duration_ms, success,
error_type?, error_code?}``.

Additions (documented, additive-only): ``CommandResponse.engine_metadata``
carries engine phase timings (queue/prefill/decode, TTFT) when a local
engine served the request — the in-process engine's counterpart of the
reference's ``duration_ms`` bookkeeping (app.py:164,227).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from pydantic import BaseModel, Field


class Query(BaseModel):
    query: str = Field(..., min_length=3, description="Natural language query for kubectl.")


class ExecuteRequest(BaseModel):
    execute: str = Field(..., description="kubectl command to execute.")


class ExecutionMetadata(BaseModel):
    start_time: str
    end_time: str
    duration_ms: float
    success: bool
    error_type: Optional[str] = None
    error_code: Optional[str] = None


class EngineMetadata(BaseModel):
    """Per-request engine phase timings (an addition to the reference's
    contract; SURVEY.md §5 tracing row)."""

    queue_ms: float = 0.0
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    detok_ms: float = 0.0
    ttft_ms: float = 0.0
    prompt_tokens: int = 0
    completion_tokens: int = 0
    tokens_per_sec: float = 0.0
    prefix_cache_hit: bool = False
    engine: str = ""


class CommandResponse(BaseModel):
    kubectl_command: str
    execution_result: Optional[Dict[str, Any]] = None
    execution_error: Optional[Dict[str, Any]] = None
    from_cache: bool = False
    metadata: ExecutionMetadata
    engine_metadata: Optional[EngineMetadata] = None
    # True when the rule-based FallbackEngine served this response because
    # the real engine was failing (DEGRADED_FALLBACK + open breaker);
    # engine_metadata.engine is then "fallback-rules".
    degraded: bool = False
    # Per-phase millisecond breakdown of this request's lifecycle
    # (obs/trace.py) — the same numbers as the Server-Timing header and
    # the /debug/requests/{id} timeline, inline for clients that want
    # them without header parsing. Additive/optional: absent when no
    # trace context was active.
    timings: Optional[Dict[str, float]] = None


class HealthResponse(BaseModel):
    """Readiness-gated health (fixes the reference's static /health,
    app.py:348-354; SURVEY.md §3.3)."""

    status: str
    engine: str = ""
    engine_ready: bool = False
    model: str = ""
    devices: int = 0
    # Failure-containment state (server/breaker.py): closed | half-open |
    # open, and whether an open breaker degrades to rule-based responses
    # instead of 503s.
    breaker: str = "closed"
    degraded_fallback: bool = False
    # Inner-ring containment (engine/containment.py): when the engine
    # last reset-and-replayed its decode state (ISO 8601) and why
    # (slot_health | scheduler_error | scheduler_death). None = never.
    last_reset: Optional[str] = None
    last_reset_cause: Optional[str] = None
    # Fleet deployments (engine/fleet.py, FLEET_SIZE > 1): the rollup —
    # replica counts by state, migration/hedge/drain/eject/rejoin
    # totals — plus a ``replicas`` list with each replica's state,
    # breaker, occupancy, and last reset/cause. None = no fleet layer.
    fleet: Optional[Dict[str, Any]] = None
    # QoS ring (engine/qos.py): per-lane queue depth, the
    # active brownout level and lane shares, preemptions in the last
    # minute, and scan-time expiry/displacement totals. None = engine
    # without the QoS scheduler (fake/openai single-sequence paths).
    qos: Optional[Dict[str, Any]] = None
    # SLO burn-rate engine (obs/slo.py): multi-window (5m/1h)
    # error-budget burn for TTFT and queue wait per lane, against the
    # SLO_TTFT_MS / SLO_INTERACTIVE_MS targets. None = engine without
    # the telemetry plane.
    slo: Optional[Dict[str, Any]] = None
    # Block-paged KV pool + radix prefix sharing
    # (engine/kv_pool.py): block counts by state (free/live/cached),
    # sharing + copy-on-write totals, and the radix tree's hit/miss
    # token counters. None = dense-KV engine (KV_POOL=false, a mesh
    # with a >1 data/pipe/seq axis, or the single-sequence/fake/openai
    # paths). TP/EP meshes serve the pool.
    kv_pool: Optional[Dict[str, Any]] = None
    # Tensor-parallel serving (parallel/sharding.py): the
    # active mesh shape + device count, the residual TP fraction the
    # f≈1 policy achieves at the decode shape, whether the KV pool is
    # mesh-sharded, and the kv_pool_mesh_fallback flag (a requested
    # pool that fell back to the dense ladder must be visible). None =
    # no serving mesh.
    sharding: Optional[Dict[str, Any]] = None
    # Grammar-constrained decoding (constrain/): the active
    # profile, compiled-grammar hash + state/class counts, forced vs
    # masked token totals, and dead ends by cause. None = GRAMMAR_DECODE
    # off or an engine without the subsystem.
    grammar: Optional[Dict[str, Any]] = None
    # Speculative decoding (engine/batcher.py): draft model
    # id, k, live/degraded state, drafted/accepted totals and the
    # acceptance ratio. None = SPEC_DECODE off or an engine without the
    # subsystem.
    spec: Optional[Dict[str, Any]] = None
    # Zero-downtime weight rollout (engine/rollout.py): the
    # state machine position, target/stable checkpoint versions, the
    # canary replica + share, the per-replica version table, and
    # cumulative rollbacks by cause. None = engine without swap support
    # (the per-replica versions also appear in the fleet section).
    rollout: Optional[Dict[str, Any]] = None
    # Perf-regression sentinel (obs/steptime.py): per-(phase,
    # bucket) step-time digests (p50/p95/p99, baseline, trailing
    # tok/s), breach verdicts, and the edge-triggered trip total; the
    # fleet rollup attributes breaches to replicas. None = engine
    # without the chunked scheduler.
    steptime: Optional[Dict[str, Any]] = None
    # Incident capture (obs/incidents.py): ring occupancy,
    # captured/suppressed totals by trigger, and the newest incident id
    # (full bundles live behind token-gated /debug/incidents).
    incidents: Optional[Dict[str, Any]] = None
