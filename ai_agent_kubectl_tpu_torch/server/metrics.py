"""Prometheus metrics for the port: the JAX package's families that the
port's features feed, under the same names, labels and help.

- HTTP: request counts and latency per method and matched route
  (unmatched routes collapse into one ``unmatched`` label).
- Service: response-cache hits and misses, rate-limited requests,
  unsafe commands, kubectl executions, HTTP and engine overload sheds
  (``queue_rejections_total{layer}``), the breaker state and degraded
  responses, and the per-phase request histogram.
- Engine: TTFT, generation latency, completion tokens, the windowed
  tokens/s gauge and prefix-cache hits, from each response; and, at
  scrape time, the pool engine's ``kv_pool_health()`` (block-state
  gauges, sharing, copy-on-write and radix counters, the decode
  attention regime, and the host tier's occupancy and demote, onload,
  onload-failure and drop totals: ``kv_host_blocks{state}``,
  ``kv_blocks_demoted_total``, ``kv_blocks_onloaded_total``,
  ``kv_onload_fail_total{cause}``, ``kv_host_blocks_dropped_total``) and
  the batched engine's ``stats()``: occupancy,
  queue depth and KV pages (``engine_*``), the decode pipeline
  (``decode_pipe_*``, ``decode_chunks_total``, ``chunk_fetch_seconds``,
  ``wasted_decode_steps_total``), the QoS section (queue depth and slot
  occupancy per lane, the brownout level, preemption, expiry and
  displacement totals), the goodput ledger (``goodput_*``), the SLO burn
  rates (``slo_*``) and the step-time sentinel (``step_time_seconds``,
  ``step_tokens_per_sec``, ``steptime_breach_trips_total``) and the
  containment totals (``engine_resets_total{cause}``,
  ``quarantined_requests_total{reason}``, ``replayed_tokens_total``,
  ``slot_health_trips_total``), the grammar totals
  (``grammar_forced_tokens_total``, ``grammar_masked_steps_total``,
  ``grammar_dead_end_total{cause}``) and the speculative-decode totals
  (``spec_drafted_tokens_total``, ``spec_accepted_tokens_total``,
  ``spec_acceptance_ratio``).
- Incidents: captured and cooldown-suppressed bundles by trigger.
- The fleet (``fleet_replicas{state}``, per-replica occupancy,
  in-flight and breaker gauges, the migration, migrated-token, hedge,
  drain, eject and rejoin totals) and the weight rollout
  (``rollout_state``, ``rollout_replicas{version}``,
  ``rollout_rollbacks_total{cause}``).

- Tensor-parallel serving: ``mesh_devices``,
  ``sharding_residual_fraction``, ``kv_pool_mesh_fallback``,
  ``spec_draft_sharded``, ``spec_draft_kv_fallback`` (the two draft
  gauges read 0: speculative decoding on a mesh is refused).

Every label set is closed
(lanes, ledger classes, phases, triggers) or bounded by config
(buckets, SLO windows). A ``CollectorRegistry`` per app keeps tests
isolated.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

from ..obs.ledger import LEDGER_CLASSES

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

_TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# Phase spans skew small (sub-ms safety checks next to multi-second
# decodes), so the phase histogram keeps finer low-end buckets.
_PHASE_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: the decode attention regimes the ``decode_attention_regime`` gauge
#: reports (one is 1, the rest 0).
ATTENTION_REGIMES = ("ragged", "paged", "gather", "dense")


class WindowedRate:
    """Rolling-window event rate for the ``engine_tokens_per_sec``
    gauge: every finished generation ``add()``s its token count, and
    the scrape reads ``rate()`` — the total over the trailing window
    divided by the whole window, so an idle window decays to 0."""

    def __init__(self, window_secs: float = 60.0,
                 timer: Callable[[], float] = time.monotonic):
        self.window_secs = window_secs
        self._timer = timer
        self._events: deque = deque()   # (t, count)

    def add(self, count: int) -> None:
        if count <= 0:
            return
        now = self._timer()
        self._events.append((now, count))
        self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_secs
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self) -> float:
        now = self._timer()
        self._prune(now)
        total = sum(c for _, c in self._events)
        return total / self.window_secs if total else 0.0


class Metrics:
    """The service's and the engine's metrics for one app instance."""

    def __init__(self) -> None:
        self.registry = CollectorRegistry()
        r = self.registry

        # HTTP
        self.http_requests = Counter(
            "http_requests_total",
            "Total HTTP requests",
            ["method", "handler", "status"],
            registry=r,
        )
        self.http_latency = Histogram(
            "http_request_duration_seconds",
            "HTTP request latency",
            ["method", "handler"],
            buckets=_LATENCY_BUCKETS,
            registry=r,
        )

        # Service layer
        self.cache_hits = Counter(
            "response_cache_hits_total", "Query→command cache hits", registry=r
        )
        self.cache_misses = Counter(
            "response_cache_misses_total", "Query→command cache misses", registry=r
        )
        self.rate_limited = Counter(
            "rate_limited_total", "Requests rejected by the rate limiter", registry=r
        )
        self.unsafe_commands = Counter(
            "unsafe_commands_total",
            "Commands rejected by the safety validator",
            ["source"],  # llm | user
            registry=r,
        )
        self.executions = Counter(
            "kubectl_executions_total", "kubectl subprocess runs", ["outcome"], registry=r
        )

        # Engine, from each response
        self.ttft = Histogram(
            "engine_ttft_seconds", "Time to first token", buckets=_TTFT_BUCKETS, registry=r
        )
        self.gen_latency = Histogram(
            "engine_generate_seconds",
            "Full generation latency",
            buckets=_LATENCY_BUCKETS,
            registry=r,
        )
        self.tokens_generated = Counter(
            "engine_tokens_generated_total", "Completion tokens produced", registry=r
        )
        self.tokens_per_sec = Gauge(
            "engine_tokens_per_sec",
            "Decode throughput averaged over the trailing 60s window",
            registry=r,
        )
        self.batch_occupancy = Gauge(
            "engine_batch_occupancy", "Active slots in the decode batch", registry=r
        )
        self.queue_depth = Gauge(
            "engine_queue_depth", "Requests waiting for a decode slot", registry=r
        )
        self.kv_pool_used = Gauge(
            "engine_kv_pages_used", "KV cache pages in use", registry=r
        )
        self.kv_pool_total = Gauge(
            "engine_kv_pages_total", "KV cache pages allocated", registry=r
        )
        self.prefix_cache_hits = Counter(
            "engine_prefix_cache_hits_total", "Prefix-KV cache hits", registry=r
        )

        # Block-paged KV pool + radix prefix sharing, from the engine's
        # kv_pool_health() at scrape time. ``state`` is the closed
        # free|live|cached set; the cumulative totals are delta-mirrored.
        self.kv_pool_blocks = Gauge(
            "kv_pool_blocks",
            "KV pool blocks by state (free | live | cached)",
            ["state"],
            registry=r,
        )
        self.kv_blocks_shared = Counter(
            "kv_blocks_shared_total",
            "Shared-block mappings handed out by the radix tree "
            "(a full prefix block mapped into another slot's table)",
            registry=r,
        )
        self.kv_cow_copies = Counter(
            "kv_cow_copies_total",
            "Copy-on-write copies of partially-filled tail blocks",
            registry=r,
        )
        self.radix_hit_tokens = Counter(
            "radix_hit_tokens_total",
            "Prompt tokens whose KV was served from the radix tree "
            "(prefill skipped)",
            registry=r,
        )
        self.radix_miss_tokens = Counter(
            "radix_miss_tokens_total",
            "Prompt tokens prefilled because no cached prefix covered "
            "them",
            registry=r,
        )
        # The two-tier KV: host-tier occupancy and the demote/onload
        # flow. ``cause`` on the onload-fail counter is the closed
        # HostBlockStore.ONLOAD_FAIL_CAUSES set (corrupt | exhausted).
        self.kv_host_blocks = Gauge(
            "kv_host_blocks",
            "Host-tier KV blocks by state (used | free)",
            ["state"],
            registry=r,
        )
        self.kv_blocks_demoted = Counter(
            "kv_blocks_demoted_total",
            "KV blocks demoted from HBM to the host-RAM tier",
            registry=r,
        )
        self.kv_blocks_onloaded = Counter(
            "kv_blocks_onloaded_total",
            "Host-tier KV blocks re-onloaded to HBM (checksum verified)",
            registry=r,
        )
        self.kv_onload_fail = Counter(
            "kv_onload_fail_total",
            "Host-tier onload failures by cause (corrupt = checksum "
            "mismatch, chain dropped + prefill fallback; exhausted = "
            "no device block free)",
            ["cause"],
            registry=r,
        )
        self.kv_host_dropped = Counter(
            "kv_host_blocks_dropped_total",
            "Host-tier blocks discarded (LRU displacement, corrupt-"
            "chain purge, or reset drain)",
            registry=r,
        )
        self._kv_pool_seen = {"shared": 0, "cow": 0, "hit": 0, "miss": 0,
                              "demoted": 0, "onloaded": 0, "dropped": 0,
                              "fail_corrupt": 0, "fail_exhausted": 0}
        self.decode_attention_regime = Gauge(
            "decode_attention_regime",
            "1 for the attention regime actually serving decode "
            "(ragged = one kernel for prefill/decode/spec-verify over "
            "the block pool; paged = single-query paged kernel; "
            "gather = dense gather over pool pages; dense = per-slot "
            "dense KV ladder)",
            ["regime"],
            registry=r,
        )

        # The decode pipeline, from stats() at scrape time: gauges set
        # directly, cumulative totals delta-mirrored, fetch latencies
        # observed from the drained per-chunk samples.
        self.pipe_occupancy = Gauge(
            "decode_pipe_occupancy",
            "Speculative decode chunks currently in flight",
            registry=r,
        )
        self.pipe_depth = Gauge(
            "decode_pipe_depth",
            "Configured CHUNK_PIPE_DEPTH",
            registry=r,
        )
        self.device_active_slots = Gauge(
            "decode_device_active_slots",
            "Live slots reported by the last consumed chunk's n_alive",
            registry=r,
        )
        self.wasted_decode_steps = Counter(
            "wasted_decode_steps_total",
            "Decode steps executed for already-terminated slots "
            "(~0 with DEVICE_TERMINATION=true)",
            registry=r,
        )
        self.decode_chunks = Counter(
            "decode_chunks_total",
            "Decode chunk pipeline events",
            ["event"],  # dispatch | consume | prune
            registry=r,
        )
        self.chunk_fetch = Histogram(
            "chunk_fetch_seconds",
            "Blocking device->host fetch latency per consumed chunk",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5),
            registry=r,
        )
        self._pipe_seen = {"wasted": 0, "dispatch": 0, "consume": 0,
                           "prune": 0}

        # The QoS ring (engine/qos.py): queue depth and slot occupancy per
        # lane (the closed three-lane set: tenants are never labels), the
        # brownout level, and the preemption, expiry and displacement
        # counters, mirrored from stats()["qos"] at scrape time.
        self.qos_queue_depth = Gauge(
            "qos_queue_depth",
            "Requests waiting for a decode slot, by priority lane",
            ["lane"],
            registry=r,
        )
        self.qos_lane_occupancy = Gauge(
            "qos_lane_occupancy",
            "Decode slots held, by priority lane",
            ["lane"],
            registry=r,
        )
        self.qos_brownout_level = Gauge(
            "qos_brownout_level",
            "AIMD brownout level (0=none, 1=background trimmed, "
            "2=batch trimmed too)",
            registry=r,
        )
        self.preemptions = Counter(
            "qos_preemptions_total",
            "Running requests preempted out of their slot for a "
            "starved higher lane (export/replay path)",
            registry=r,
        )
        self.preempted_tokens = Counter(
            "qos_preempted_tokens_total",
            "Generated tokens carried across preempt-and-replay",
            registry=r,
        )
        self.queue_expired = Counter(
            "queue_expired_total",
            "Queued requests purged at scan time because their deadline "
            "passed (they no longer occupy MAX_QUEUE_DEPTH)",
            registry=r,
        )
        self.queue_displaced = Counter(
            "queue_displaced_total",
            "Queued requests displaced from a full queue in favour of a "
            "quieter tenant's arrival (shed prefers the flooding tenant)",
            registry=r,
        )
        self._qos_seen = {"preemptions": 0, "preempted_tokens": 0,
                          "expired": 0, "displaced": 0}

        # Goodput ledger (obs/ledger.py): device decode steps by class
        # and lane — both closed sets; tenants are never labels (the
        # per-tenant table lives behind /debug/ledger only).
        self.goodput_steps = Counter(
            "goodput_steps_total",
            "Device decode steps by accounting class and lane "
            "(delivered = goodput; the rest are waste classes)",
            ["lane", "class"],
            registry=r,
        )
        self.goodput_ratio = Gauge(
            "goodput_ratio",
            "Delivered fraction of all accounted device steps, by lane",
            ["lane"],
            registry=r,
        )
        self._ledger_seen: dict = {}

        # SLO burn rates (obs/slo.py): ``slo`` and ``lane`` are closed
        # sets; ``window`` values come from SLO_WINDOWS (at most 4).
        self.slo_burn_rate = Gauge(
            "slo_burn_rate",
            "Error-budget burn rate over the window (1.0 = spending "
            "exactly at the objective's sustainable rate)",
            ["slo", "lane", "window"],
            registry=r,
        )
        self.slo_budget_remaining = Gauge(
            "slo_error_budget_remaining",
            "Unspent fraction of the window's error budget (floor 0)",
            ["slo", "lane", "window"],
            registry=r,
        )
        self.slo_breaches = Counter(
            "slo_breaches_total",
            "Latency samples that breached their SLO target",
            ["slo", "lane"],
            registry=r,
        )
        self._slo_seen: dict = {}

        # Step-time sentinel (obs/steptime.py): ``phase`` is the closed
        # STEP_PHASES set; ``bucket`` values come from the engine's
        # bucket ladders.
        self.step_time = Gauge(
            "step_time_seconds",
            "Per-chunk device step time quantiles by phase and bucket "
            "(p50 | p95 | p99 over the sentinel's trailing window)",
            ["phase", "bucket", "quantile"],
            registry=r,
        )
        self.step_tokens_per_sec = Gauge(
            "step_tokens_per_sec",
            "Trailing tokens/sec produced at this (phase, bucket) rung",
            ["phase", "bucket"],
            registry=r,
        )
        self.steptime_trips = Counter(
            "steptime_breach_trips_total",
            "Step-time sentinel breach transitions (p99 crossed the "
            "baseline envelope; edge-triggered, not per scrape)",
            registry=r,
        )
        self._steptime_seen = 0

        # Incident capture (obs/incidents.py), by the closed TRIGGERS set.
        self.incidents_captured = Counter(
            "incidents_captured_total",
            "Incident bundles assembled into the /debug/incidents ring",
            ["trigger"],
            registry=r,
        )
        self.incidents_suppressed = Counter(
            "incidents_suppressed_total",
            "Trigger firings swallowed by the per-trigger cooldown "
            "(counted, never captured — bounds capture overhead)",
            ["trigger"],
            registry=r,
        )
        self._incidents_seen = {"captured": {}, "suppressed": {}}

        # Failure containment: overload shedding, breaker, fallback
        self.queue_rejections = Counter(
            "queue_rejections_total",
            "Requests shed by overload protection",
            ["layer"],  # http (inflight cap) | engine (admission queue)
            registry=r,
        )
        self.breaker_state = Gauge(
            "breaker_state",
            "Circuit breaker state (0=closed, 1=half-open, 2=open)",
            registry=r,
        )
        self.degraded_responses = Counter(
            "degraded_responses_total",
            "Responses served by the rule-based fallback engine",
            registry=r,
        )

        # Blast-radius containment (the inner ring): engine resets by
        # cause, terminal quarantines by reason, device health trips and
        # tokens regenerated by reset-and-replay. The totals live on the
        # engine's supervisor; scrapes mirror their deltas
        # (observe_containment).
        self.engine_resets = Counter(
            "engine_resets_total",
            "Decode-state reset-and-replay cycles",
            ["cause"],  # slot_health | scheduler_error | scheduler_death
            registry=r,
        )
        self.quarantined_requests = Counter(
            "quarantined_requests_total",
            "Requests terminally quarantined by culprit isolation",
            ["reason"],  # slot_health | step_poison
            registry=r,
        )
        self.replayed_tokens = Counter(
            "replayed_tokens_total",
            "Already-generated tokens re-spliced and replayed across "
            "engine resets (innocent-victim recovery)",
            registry=r,
        )
        self.slot_health_trips = Counter(
            "slot_health_trips_total",
            "Per-slot device health-word trips (NaN/Inf logits, "
            "out-of-range token ids) caught in the decode chunk",
            registry=r,
        )
        self._containment_seen = {"resets": {}, "quarantined": {},
                                  "health_trips": 0, "replayed_tokens": 0}

        # Grammar-constrained decoding: tokens delivered by forced-run
        # splices against tokens sampled under the device-side mask, and
        # FSM dead ends by cause (a closed set: decode | admission).
        # Delta-mirrored from stats()["grammar"] (observe_grammar).
        self.grammar_forced_tokens = Counter(
            "grammar_forced_tokens_total",
            "Tokens delivered by forced-run fast-forward splices "
            "(single-successor FSM chains written as one suffix "
            "prefill instead of decoded token-by-token)",
            registry=r,
        )
        self.grammar_masked_steps = Counter(
            "grammar_masked_steps_total",
            "Decode steps sampled under the grammar's device-side "
            "logit mask",
            registry=r,
        )
        self.grammar_dead_ends = Counter(
            "grammar_dead_end_total",
            "Slots frozen in a grammar dead end (no legal token from "
            "the current FSM state)",
            ["cause"],
            registry=r,
        )
        self._grammar_seen = {"forced": 0, "masked": 0, "dead": {}}

        # Speculative decoding: draft proposals against verifier
        # acceptances, and the cumulative ratio (a gauge set from the
        # two totals). Delta-mirrored from stats()["spec"] (observe_spec).
        self.spec_drafted_tokens = Counter(
            "spec_drafted_tokens_total",
            "Draft-model token proposals submitted to the verifier",
            registry=r,
        )
        self.spec_accepted_tokens = Counter(
            "spec_accepted_tokens_total",
            "Draft proposals the target model's verify step accepted "
            "(each one is a transcript token that cost no extra "
            "target forward)",
            registry=r,
        )
        self.spec_acceptance_ratio = Gauge(
            "spec_acceptance_ratio",
            "Cumulative accepted/drafted ratio of speculative decoding",
            registry=r,
        )
        self._spec_seen = {"drafted": 0, "accepted": 0}

        # Tensor-parallel serving (MESH_SHAPE=tp=N): the mesh's device
        # count, the residual fraction the policy splits at the decode
        # shape, and the loud-fallback flags; gauges sampled at scrape
        # time from stats()["sharding"].
        self.mesh_devices = Gauge(
            "mesh_devices",
            "Devices in the active serving mesh (0 = single device)",
            registry=r,
        )
        self.sharding_residual_fraction = Gauge(
            "sharding_residual_fraction",
            "Residual TP-shardable fraction f achieved by the active "
            "sharding policy at the decode shape (1.0 = full f~1 "
            "residual-path sharding)",
            registry=r,
        )
        self.kv_pool_mesh_fallback = Gauge(
            "kv_pool_mesh_fallback",
            "1 when KV_POOL was requested but the mesh forced the "
            "dense KV ladder (data/pipe/seq axis > 1) — a silent "
            "dense fallback must be visible",
            registry=r,
        )
        self.spec_draft_sharded = Gauge(
            "spec_draft_sharded",
            "1 when the speculative draft model's params/KV are "
            "sharded over the serving mesh",
            registry=r,
        )
        self.spec_draft_kv_fallback = Gauge(
            "spec_draft_kv_fallback",
            "1 when the draft's KV heads do not divide the mesh's "
            "model axis and its KV cache serves replicated (gather "
            "fallback) — a silent gather must be visible",
            registry=r,
        )

        # The engine fleet (engine/fleet.py, FLEET_SIZE > 1): replica
        # counts by lifecycle state, per-replica occupancy, in-flight and
        # breaker gauges (the ``replica`` label is the index, bounded by
        # FLEET_SIZE), and the migration, hedge, drain, eject and rejoin
        # totals, delta-mirrored from stats()["fleet"] (observe_fleet).
        self.fleet_replicas = Gauge(
            "fleet_replicas",
            "Fleet replicas by lifecycle state",
            ["state"],  # active | draining | ejected
            registry=r,
        )
        self.fleet_replica_occupancy = Gauge(
            "fleet_replica_occupancy",
            "Active decode slots per fleet replica",
            ["replica"],
            registry=r,
        )
        self.fleet_replica_inflight = Gauge(
            "fleet_replica_inflight",
            "Fleet requests currently dispatched to each replica",
            ["replica"],
            registry=r,
        )
        self.fleet_replica_breaker = Gauge(
            "fleet_replica_breaker_state",
            "Per-replica circuit breaker (0=closed, 1=half-open, 2=open)",
            ["replica"],
            registry=r,
        )
        self.fleet_migrations = Counter(
            "fleet_migrations_total",
            "Requests migrated across replicas (crash failover + drains)",
            registry=r,
        )
        self.fleet_migrated_tokens = Counter(
            "fleet_migrated_tokens_total",
            "Generated tokens carried across replica migrations",
            registry=r,
        )
        self.fleet_hedges = Counter(
            "fleet_hedges_total",
            "Hedged re-dispatches fired past FLEET_HEDGE_MS",
            registry=r,
        )
        self.fleet_drains = Counter(
            "fleet_drains_total",
            "Voluntary replica drains started",
            registry=r,
        )
        self.fleet_ejects = Counter(
            "fleet_ejects_total",
            "Replicas ejected from rotation (evictions)",
            registry=r,
        )
        self.fleet_rejoins = Counter(
            "fleet_rejoins_total",
            "Replicas restarted and returned to rotation",
            registry=r,
        )
        self._fleet_seen = {"migrations": 0, "migrated_tokens": 0,
                            "hedges": 0, "drains": 0, "ejects": 0,
                            "rejoins": 0}

        # The weight rollout (engine/rollout.py): the state machine's
        # position (its index in the closed ROLLOUT_STATES), replicas by
        # the version they serve (stale version labels zeroed; at most
        # FLEET_SIZE + 1 live at once), and rollbacks by cause (the closed
        # ROLLBACK_CAUSES), mirrored from the controller's health view
        # (observe_rollout).
        self.rollout_state = Gauge(
            "rollout_state",
            "Weight-rollout state machine position (0=idle, 1=draining, "
            "2=swapping, 3=warming, 4=observing, 5=promoting, "
            "6=rolling_back, 7=rolled_back, 8=complete, 9=failed)",
            registry=r,
        )
        self.rollout_replicas = Gauge(
            "rollout_replicas",
            "Fleet replicas by the checkpoint version they serve",
            ["version"],
            registry=r,
        )
        self.rollout_rollbacks = Counter(
            "rollout_rollbacks_total",
            "Automatic weight-rollout rollbacks",
            ["cause"],
            registry=r,
        )
        self._rollout_seen: dict = {}
        self._rollout_versions_seen: set = set()

        # Request-lifecycle phases (obs/trace.py): the ``phase`` label is
        # drawn from the fixed obs.PHASES allowlist.
        self.request_phase = Histogram(
            "request_phase_seconds",
            "Per-request time spent in each lifecycle phase",
            ["phase"],
            buckets=_PHASE_BUCKETS,
            registry=r,
        )

    def observe_grammar(self, grammar: dict) -> None:
        """Mirror the engine's grammar totals (``stats()["grammar"]``)
        into the counters, by delta, as ``observe_containment`` does."""
        seen = self._grammar_seen
        for key, counter, total in (
                ("forced", self.grammar_forced_tokens,
                 grammar.get("forced_tokens_total", 0)),
                ("masked", self.grammar_masked_steps,
                 grammar.get("masked_steps_total", 0))):
            if total > seen[key]:
                counter.inc(total - seen[key])
                seen[key] = total
        for cause, total in (grammar.get("dead_ends_total") or {}).items():
            prev = seen["dead"].get(cause, 0)
            if total > prev:
                self.grammar_dead_ends.labels(cause=cause).inc(total - prev)
                seen["dead"][cause] = total

    def observe_spec(self, spec: dict) -> None:
        """Mirror the engine's speculative totals (``stats()["spec"]``)
        into the counters, by delta, and the ratio gauge from the
        cumulative totals."""
        seen = self._spec_seen
        for key, counter, total in (
                ("drafted", self.spec_drafted_tokens,
                 spec.get("drafted_tokens_total", 0)),
                ("accepted", self.spec_accepted_tokens,
                 spec.get("accepted_tokens_total", 0))):
            if total > seen[key]:
                counter.inc(total - seen[key])
                seen[key] = total
        drafted = spec.get("drafted_tokens_total", 0)
        if drafted:
            self.spec_acceptance_ratio.set(
                spec.get("accepted_tokens_total", 0) / drafted)

    #: breaker-state encoding of the per-replica gauge
    _BREAKER_CODES = {"closed": 0, "half-open": 1, "open": 2}

    def observe_fleet(self, fleet: dict) -> None:
        """Mirror the fleet rollup (``stats()["fleet"]``): gauges set,
        the cumulative fleet totals delta-inc'd."""
        for state in ("active", "draining", "ejected"):
            self.fleet_replicas.labels(state=state).set(
                fleet.get(state, 0))
        for rep in fleet.get("replicas", ()):
            label = str(rep.get("replica", "?"))
            self.fleet_replica_occupancy.labels(replica=label).set(
                rep.get("occupancy", 0))
            self.fleet_replica_inflight.labels(replica=label).set(
                rep.get("inflight", 0))
            self.fleet_replica_breaker.labels(replica=label).set(
                self._BREAKER_CODES.get(rep.get("breaker"), 0))
        seen = self._fleet_seen
        for key, counter in (("migrations", self.fleet_migrations),
                             ("migrated_tokens", self.fleet_migrated_tokens),
                             ("hedges", self.fleet_hedges),
                             ("drains", self.fleet_drains),
                             ("ejects", self.fleet_ejects),
                             ("rejoins", self.fleet_rejoins)):
            total = fleet.get(key, 0)
            if total > seen[key]:
                counter.inc(total - seen[key])
                seen[key] = total

    def observe_rollout(self, rollout: dict) -> None:
        """Mirror the rollout controller's health view: the state gauge
        by index, replicas per version (a version no replica serves any
        more reads 0), rollbacks by cause delta-inc'd."""
        from ..engine.rollout import ROLLOUT_STATES

        try:
            code = ROLLOUT_STATES.index(rollout.get("state", "idle"))
        except ValueError:   # pragma: no cover - a future state
            code = 0
        self.rollout_state.set(code)
        versions: dict = {}
        for v in (rollout.get("replica_versions") or {}).values():
            if v:
                versions[v] = versions.get(v, 0) + 1
        for v, n in versions.items():
            self.rollout_replicas.labels(version=v).set(n)
            self._rollout_versions_seen.add(v)
        for v in self._rollout_versions_seen - set(versions):
            self.rollout_replicas.labels(version=v).set(0)
        for cause, total in (rollout.get("rollbacks_total")
                             or {}).items():
            prev = self._rollout_seen.get(cause, 0)
            if total > prev:
                self.rollout_rollbacks.labels(cause=cause).inc(
                    total - prev)
                self._rollout_seen[cause] = total

    def observe_containment(self, stats: dict) -> None:
        """Mirror the supervisor's containment totals
        (``stats()["containment"]``) into the labelled counters, by
        delta, as ``observe_pipeline`` does."""
        c = stats.get("containment")
        if not c:
            return
        seen = self._containment_seen
        for cause, total in c.get("resets", {}).items():
            prev = seen["resets"].get(cause, 0)
            if total > prev:
                self.engine_resets.labels(cause=cause).inc(total - prev)
                seen["resets"][cause] = total
        for reason, total in c.get("quarantined", {}).items():
            prev = seen["quarantined"].get(reason, 0)
            if total > prev:
                self.quarantined_requests.labels(reason=reason).inc(
                    total - prev)
                seen["quarantined"][reason] = total
        for key, counter in (("health_trips", self.slot_health_trips),
                             ("replayed_tokens", self.replayed_tokens)):
            total = c.get(key, 0)
            if total > seen[key]:
                counter.inc(total - seen[key])
                seen[key] = total

    def observe_pipeline(self, stats: dict) -> None:
        """Mirror the engine's decode-pipeline stats at scrape time:
        gauges set directly, cumulative totals turned into counter
        increments, drained chunk-fetch samples observed."""
        self.pipe_occupancy.set(stats.get("pipe_inflight", 0))
        self.pipe_depth.set(stats.get("pipe_depth", 0))
        self.device_active_slots.set(stats.get("device_active_slots", 0))
        wasted = stats.get("wasted_decode_steps", 0)
        if wasted > self._pipe_seen["wasted"]:
            self.wasted_decode_steps.inc(wasted - self._pipe_seen["wasted"])
            self._pipe_seen["wasted"] = wasted
        for event, key in (("dispatch", "chunks_dispatched"),
                           ("consume", "chunks_consumed"),
                           ("prune", "chunks_pruned")):
            total = stats.get(key, 0)
            if total > self._pipe_seen[event]:
                self.decode_chunks.labels(event=event).inc(
                    total - self._pipe_seen[event])
                self._pipe_seen[event] = total
        for s in stats.get("chunk_fetch_secs", ()):
            self.chunk_fetch.observe(s)

    def observe_ledger(self, ledger: dict) -> None:
        """Mirror the ledger's lane table (stats()["ledger"]): per-(lane,
        class) totals delta-inc'd, the per-lane goodput ratio set."""
        for lane, row in (ledger.get("lanes") or {}).items():
            seen = self._ledger_seen.setdefault(lane, {})
            for cls in LEDGER_CLASSES:
                total = row.get(cls, 0)
                prev = seen.get(cls, 0)
                if total > prev:
                    # positional labels: "class" is a Python keyword.
                    self.goodput_steps.labels(lane, cls).inc(total - prev)
                    seen[cls] = total
            lane_total = row.get("total", 0)
            if lane_total:
                self.goodput_ratio.labels(lane=lane).set(
                    row.get("delivered", 0) / lane_total)

    def observe_steptime(self, st: dict) -> None:
        """Mirror the step-time snapshot (stats()["steptime"]): quantile
        and rate gauges set, the edge-triggered trip total delta-inc'd."""
        for d in (st.get("digests") or {}).values():
            phase = str(d.get("phase", "?"))
            bucket = str(d.get("bucket", "?"))
            for q, key in (("p50", "p50_ms"), ("p95", "p95_ms"),
                           ("p99", "p99_ms")):
                self.step_time.labels(
                    phase=phase, bucket=bucket, quantile=q).set(
                    float(d.get(key, 0.0)) / 1000.0)
            self.step_tokens_per_sec.labels(
                phase=phase, bucket=bucket).set(d.get("tok_s", 0.0))
        total = int(st.get("trips_total", 0))
        if total > self._steptime_seen:
            self.steptime_trips.inc(total - self._steptime_seen)
            self._steptime_seen = total

    def observe_incidents(self, snap: dict) -> None:
        """Delta-mirror the incident manager's captured and suppressed
        totals by trigger."""
        seen = self._incidents_seen
        for key, counter in (("captured", self.incidents_captured),
                             ("suppressed", self.incidents_suppressed)):
            for trigger, total in (snap.get(f"{key}_total")
                                   or {}).items():
                prev = seen[key].get(trigger, 0)
                if total > prev:
                    counter.labels(trigger=trigger).inc(total - prev)
                    seen[key][trigger] = total

    def observe_slo(self, slo: dict) -> None:
        """Mirror the SLO snapshot (stats()["slo"]): per-window burn and
        budget gauges set, cumulative breach counts delta-inc'd."""
        for name, body in (slo.get("slos") or {}).items():
            for lane, row in (body.get("lanes") or {}).items():
                for window, win in (row.get("windows") or {}).items():
                    self.slo_burn_rate.labels(
                        slo=name, lane=lane, window=window).set(
                        win.get("burn_rate", 0.0))
                    self.slo_budget_remaining.labels(
                        slo=name, lane=lane, window=window).set(
                        win.get("budget_remaining", 1.0))
                total = row.get("breaches_total", 0)
                prev = self._slo_seen.get((name, lane), 0)
                if total > prev:
                    self.slo_breaches.labels(slo=name, lane=lane).inc(
                        total - prev)
                    self._slo_seen[(name, lane)] = total

    def observe_qos(self, qos: dict) -> None:
        """Mirror the engine's ``stats()["qos"]`` at scrape time: gauges
        set directly, cumulative totals turned into counter increments."""
        for lane, n in (qos.get("lane_depth") or {}).items():
            self.qos_queue_depth.labels(lane=lane).set(n)
        for lane, n in (qos.get("lane_occupancy") or {}).items():
            self.qos_lane_occupancy.labels(lane=lane).set(n)
        self.qos_brownout_level.set(qos.get("brownout_level", 0))
        seen = self._qos_seen
        for key, counter in (("preemptions", self.preemptions),
                             ("preempted_tokens", self.preempted_tokens),
                             ("expired", self.queue_expired),
                             ("displaced", self.queue_displaced)):
            total = qos.get(key, 0)
            if total > seen[key]:
                counter.inc(total - seen[key])
                seen[key] = total

    def observe_sharding(self, sharding: dict) -> None:
        """Mirror the engine's sharding view (stats()["sharding"]) at
        scrape time: plain gauges of config-derived states."""
        self.mesh_devices.set(sharding.get("devices", 0))
        self.sharding_residual_fraction.set(
            sharding.get("residual_tp_fraction", 0.0))
        self.kv_pool_mesh_fallback.set(
            1 if sharding.get("kv_pool_mesh_fallback") else 0)
        self.spec_draft_sharded.set(
            1 if sharding.get("draft_sharded") else 0)
        self.spec_draft_kv_fallback.set(
            1 if sharding.get("draft_kv_fallback") else 0)
        active = sharding.get("attention_regime")
        if active:
            for regime in ATTENTION_REGIMES:
                self.decode_attention_regime.labels(regime=regime).set(
                    1 if regime == active else 0)

    def observe_kv_pool(self, pool: dict) -> None:
        """Mirror the engine's ``kv_pool_health()`` body at scrape time:
        block-state gauges set directly, the cumulative sharing, COW,
        radix and host-tier totals turned into counter increments."""
        for state in ("free", "live", "cached"):
            self.kv_pool_blocks.labels(state=state).set(pool.get(state, 0))
        active = pool.get("attention_regime")
        if active:
            for regime in ATTENTION_REGIMES:
                self.decode_attention_regime.labels(regime=regime).set(
                    1 if regime == active else 0)
        seen = self._kv_pool_seen
        radix = pool.get("radix") or {}
        for key, counter, total in (
                ("shared", self.kv_blocks_shared,
                 pool.get("shared_mapped_total", 0)),
                ("cow", self.kv_cow_copies,
                 pool.get("cow_copies_total", 0)),
                ("hit", self.radix_hit_tokens, radix.get("hit_tokens", 0)),
                ("miss", self.radix_miss_tokens,
                 radix.get("miss_tokens", 0))):
            if total > seen[key]:
                counter.inc(total - seen[key])
                seen[key] = total
        # The host tier: absent at HOST_KV_BLOCKS=0, where its gauges and
        # counters never move.
        host = pool.get("host_tier")
        if host:
            self.kv_host_blocks.labels(state="used").set(
                host.get("used", 0))
            self.kv_host_blocks.labels(state="free").set(
                host.get("free", 0))
            fails = host.get("onload_fail_total") or {}
            for key, counter, total in (
                    ("demoted", self.kv_blocks_demoted,
                     host.get("demoted_total", 0)),
                    ("onloaded", self.kv_blocks_onloaded,
                     host.get("onloaded_total", 0)),
                    ("dropped", self.kv_host_dropped,
                     host.get("dropped_total", 0)),
                    ("fail_corrupt",
                     self.kv_onload_fail.labels(cause="corrupt"),
                     fails.get("corrupt", 0)),
                    ("fail_exhausted",
                     self.kv_onload_fail.labels(cause="exhausted"),
                     fails.get("exhausted", 0))):
                if total > seen[key]:
                    counter.inc(total - seen[key])
                    seen[key] = total

    def render(self) -> bytes:
        return generate_latest(self.registry)
