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
  attention regime) and the batched engine's ``stats()["qos"]`` (queue
  depth and slot occupancy per lane, the brownout level, preemption,
  expiry and displacement totals).

The JAX package's families of features the port does not serve yet
(decode pipeline, containment, fleet, ledger, SLO, grammar,
speculative decode, sharding, rollout, step-time sentinel, incidents,
the two-tier KV, and the ``engine.stats()`` gauges) wait for a later
slice (ROADMAP.md A9). A ``CollectorRegistry`` per app keeps tests
isolated.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

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
        self._kv_pool_seen = {"shared": 0, "cow": 0, "hit": 0, "miss": 0}
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

        # Request-lifecycle phases (obs/trace.py): the ``phase`` label is
        # drawn from the fixed obs.PHASES allowlist.
        self.request_phase = Histogram(
            "request_phase_seconds",
            "Per-request time spent in each lifecycle phase",
            ["phase"],
            buckets=_PHASE_BUCKETS,
            registry=r,
        )

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

    def observe_kv_pool(self, pool: dict) -> None:
        """Mirror the engine's ``kv_pool_health()`` body at scrape time:
        block-state gauges set directly, the cumulative sharing, COW and
        radix totals turned into counter increments."""
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

    def render(self) -> bytes:
        return generate_latest(self.registry)
