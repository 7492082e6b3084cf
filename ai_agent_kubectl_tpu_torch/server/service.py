"""The service layer behind the HTTP routes, free of any web framework.

The counterpart of the JAX package's ``server/app.py::Service``: it
bundles the app's long-lived components — the engine, the kubectl
executor, the metrics, the TTL response cache with single flight, the
rate limiter, the circuit breaker, the optional rule-based fallback,
the flight recorder, the incident manager and the weight-rollout
controller (``engine/rollout.py``, built against the unwrapped engine:
a fleet whose replicas all swap, or one swap-capable engine) — and runs
the ``POST
/kubectl-command`` pipeline (``generate_command``): cache, then engine
(under the breaker), then the safety parser; engine failures degrade to
the rule table when ``DEGRADED_FALLBACK`` is set. Under
``GRAMMAR_DECODE`` the response cache is keyed by the request's grammar
identity too (``cache_key``). ``check_incidents`` is
one trigger-evaluation round over the engine's cheap health views (the
background watcher, the /metrics scrape and /debug/incidents reads
share it). The routes and the middleware live in ``server/app.py``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
from contextlib import nullcontext
from typing import Optional, Tuple

from ..constrain import cache_scope, current_grammar
from ..engine.fallback import FallbackEngine
from ..engine.prompts import render_prompt
from ..engine.protocol import (EngineOverloaded, EngineResult,
                               EngineUnavailable, GenerationTimeout,
                               RequestQuarantined, TenantOverloaded)
from ..engine.qos import current_qos
from ..obs import FlightRecorder, IncidentManager, current_trace
from .breaker import CircuitBreaker
from .cache import CachedSingleFlight
from .executor import CommandExecutor
from .metrics import Metrics, WindowedRate
from .output_parser import UnsafeCommandError, parse_llm_output
from .ratelimit import SlidingWindowLimiter

logger = logging.getLogger(__name__)


def status_for_text(text: str) -> int:
    """The status the service answers for the model text ``text``: 200
    when it parses into a safe single-line kubectl command, else 422."""
    try:
        parse_llm_output(text)
    except UnsafeCommandError:
        return 422
    return 200


def shed_answer(e: EngineOverloaded) -> Tuple[int, str]:
    """Status and detail of an engine shed, as the JAX app answers: 429
    for a tenant over its queue cap (the flooding tenant backs off,
    everyone else keeps being served), 503 for a full queue."""
    if isinstance(e, TenantOverloaded):
        return 429, f"Tenant over queue quota: {e}"
    return 503, f"Server overloaded: {e}"


def span(name: str, **meta):
    """Span on the active trace, or a no-op when none is active."""
    trace = current_trace()
    if trace is not None:
        return trace.span(name, **meta)
    return nullcontext()


class Service:
    """The app's long-lived components and the generation pipeline."""

    def __init__(self, cfg, engine,
                 executor: Optional[CommandExecutor] = None,
                 metrics: Optional[Metrics] = None):
        self.cfg = cfg
        self.engine = engine
        self.executor = executor or CommandExecutor(
            timeout=cfg.execution_timeout)
        self.metrics = metrics or Metrics()
        self.cache: CachedSingleFlight[str, str] = CachedSingleFlight(
            cfg.cache_maxsize, cfg.cache_ttl)
        self.limiter = SlidingWindowLimiter(cfg.rate_limit_count,
                                            cfg.rate_limit_window)
        self.breaker = CircuitBreaker(
            threshold=cfg.breaker_threshold,
            window_secs=cfg.breaker_window_secs,
            recovery_secs=cfg.breaker_recovery_secs,
        )
        self.fallback: Optional[FallbackEngine] = (
            FallbackEngine() if cfg.degraded_fallback else None)
        #: generation requests in flight (the overload middleware's count)
        self.inflight_requests = 0
        self.recorder = FlightRecorder(cfg.flight_recorder_size)
        self.token_rate = WindowedRate()
        # The tenant -> tier map the QoS middleware classifies against
        # (a typo'd TENANT_TIERS already refused to boot).
        self.tenant_tiers = cfg.tenant_tier_map
        # Incident capture: the manager watches the engine's cheap health
        # views for firing triggers and files bounded evidence bundles
        # behind /debug/incidents; the secret-free config fingerprint
        # rides every bundle.
        self.incidents = IncidentManager(
            ring=cfg.incident_ring,
            cooldown_secs=cfg.incident_cooldown_secs,
            burn_threshold=cfg.incident_burn_threshold,
            thrash_min_blocks=cfg.incident_thrash_min_blocks)
        self.config_fingerprint = hashlib.sha256(
            json.dumps(cfg.describe(), sort_keys=True,
                       default=repr).encode()).hexdigest()[:12]
        # Inner ring into outer ring: every engine reset counts as a
        # breaker failure, so a reset storm opens the breaker even while
        # requests keep recovering. The supervisor calls from the
        # scheduler thread; the failure is marshalled onto the event
        # loop once one has been seen (breaker transitions run there).
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        hook = getattr(engine, "set_reset_listener", None)
        if callable(hook):
            hook(self._on_engine_reset)
        # Zero-downtime weight rollout: drain, swap, warm-up, rejoin,
        # observe, then promote or roll back, over the fleet (or one
        # swap-capable engine: the in-place swap). Built against the
        # unwrapped engine, since a generate-fault ChaosEngine sits
        # above the fleet and lifecycle calls must reach the replicas;
        # absent (404 at /admin/rollout) unless every replica can swap.
        self.rollout = None
        if all(callable(getattr(eng, "swap_weights", None))
               for _, eng in self._replica_engines()):
            from ..engine.rollout import RolloutController

            self.rollout = RolloutController(
                getattr(engine, "inner", engine),
                canary_share=cfg.rollout_canary_share,
                observe_secs=cfg.rollout_observe_secs,
                burn_gate=cfg.rollout_burn_gate,
                steptime_gate=cfg.rollout_steptime_gate,
                drain_secs=cfg.drain_timeout_secs,
            )

    def _on_engine_reset(self, cause: str) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self.breaker.record_failure)
        else:  # pragma: no cover - a reset before any traffic
            self.breaker.record_failure()

    def _replica_engines(self) -> list:
        """(replica key, engine) of every engine behind the wrapper: each
        replica of a fleet, else the one engine as replica "0"."""
        target = getattr(self.engine, "inner", self.engine)
        if hasattr(target, "replicas"):
            return [(str(rep.idx), rep.engine) for rep in target.replicas]
        return [("0", target)]

    def _quarantine_total(self) -> Optional[int]:
        """Terminal quarantines so far across every replica's supervisor
        (attribute reads, never stats()); None without a supervisor."""
        sups = [getattr(eng, "supervisor", None)
                for _, eng in self._replica_engines()]
        sups = [sup for sup in sups if sup is not None]
        if not sups:
            return None
        return sum(sum(getattr(sup, "quarantined", {}).values())
                   for sup in sups)

    # ------------------------------------------------------- incidents

    def _engine_view(self, name: str) -> Optional[dict]:
        """One cheap engine health view, or None (absent or failing):
        the incident plane never takes the serving path down."""
        fn = getattr(self.engine, name, None)
        if not callable(fn):
            return None
        try:
            return fn() or None
        except Exception:  # pragma: no cover - defensive
            return None

    def _chunk_rings(self, limit: int = 64) -> dict:
        """The tails of the schedulers' chunk-event rings (the
        /debug/chunks evidence, frozen into a bundle), keyed by replica
        as in the JAX package. Each copy retries on a concurrent-mutation
        RuntimeError."""
        out = {}
        for key, eng in self._replica_engines():
            log = getattr(eng, "_chunk_log", None)
            if log is None:
                continue
            events: list = []
            for _ in range(5):
                try:
                    events = list(log)
                    break
                except RuntimeError:
                    continue
            out[key] = events[-limit:]
        return out

    def _incident_bundle(self) -> dict:
        """One bounded evidence bundle, under the JAX bundle's keys: the
        flight recorder, the chunk rings, every cheap health section (None
        for a feature the port does not serve), the config fingerprint
        and the weights version."""
        return {
            "weights_version": (str(getattr(self.engine,
                                            "weights_version", "") or "")
                                or None),
            "config_fingerprint": self.config_fingerprint,
            "breaker": self.breaker.state,
            "flight_recorder": self.recorder.list(limit=32),
            "chunks": self._chunk_rings(),
            "ledger": self._engine_view("ledger_snapshot"),
            "slo": self._engine_view("slo_health"),
            "qos": self._engine_view("qos_health"),
            "kv_pool": self._engine_view("kv_pool_health"),
            "sharding": self._engine_view("sharding_health"),
            "grammar": self._engine_view("grammar_health"),
            "spec": self._engine_view("spec_health"),
            "fleet": self._engine_view("fleet_health"),
            "steptime": self._engine_view("steptime_health"),
            "rollout": (self.rollout.health()
                        if self.rollout is not None else None),
        }

    def check_incidents(self) -> list:
        """One trigger-evaluation round; returns the NEW bundles. The
        quarantine count is the supervisor's (None for an engine without
        one); the pool view carries the starved-slot count and, with the
        host tier on, its ``host_tier`` stats."""
        views = {
            "steptime": self._engine_view("steptime_health"),
            "slo": self._engine_view("slo_health"),
            "kv_pool": self._engine_view("kv_pool_health"),
            "grammar": self._engine_view("grammar_health"),
            "breaker": self.breaker.state,
            "quarantined_total": self._quarantine_total(),
        }
        return self.incidents.evaluate(views, self._incident_bundle)

    async def run_engine(self, coro_fn):
        """One engine call under the circuit breaker: fail fast while the
        breaker is open (a half-open probe is the exception), count every
        engine failure, close on success. Overload sheds and quarantines
        pass through untouched: neither says the engine is broken.
        Readiness is sampled before the call, so "engine not started"
        rejections during a restart do not open the breaker."""
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        token = self.breaker.begin()
        if token is None:
            raise EngineUnavailable(
                f"circuit breaker {self.breaker.state}: engine calls "
                "suspended until a half-open probe succeeds")
        was_ready = bool(getattr(self.engine, "ready", True))
        decided = False
        try:
            result = await coro_fn()
        except RequestQuarantined:
            raise
        except EngineOverloaded:
            # Counted here, once per actual engine shed, not per
            # coalesced single-flight waiter.
            self.metrics.queue_rejections.labels("engine").inc()
            trace = current_trace()
            if trace is not None:
                trace.shed = True
            raise
        except Exception:
            decided = True
            if was_ready:
                self.breaker.record_failure(token)
            else:
                self.breaker.release_probe(token)
            raise
        else:
            decided = True
            self.breaker.record_success(token)
            return result
        finally:
            # An undecided exit (overload, quarantine, cancellation) must
            # release a half-open probe slot, or the breaker wedges.
            if not decided:
                self.breaker.release_probe(token)

    async def degraded_command(self, sanitized_query: str,
                               cause: BaseException
                               ) -> Tuple[str, EngineResult]:
        """Serve the query from the rule table. Never touches the
        response cache: a rule answer must not shadow a real generation
        after recovery."""
        logger.warning(
            "Serving degraded fallback for query '%s' (breaker=%s): %s",
            sanitized_query, self.breaker.state, cause)
        trace = current_trace()
        if trace is not None:
            trace.degraded = True
            trace.event(f"fallback: engine failed ({cause}); serving "
                        f"rule-based response (breaker={self.breaker.state})")
        with span("fallback"):
            result = await self.fallback.generate(
                render_prompt(sanitized_query))
        command = parse_llm_output(result.text)
        self.metrics.degraded_responses.inc()
        # The request consulted the cache and missed before the engine
        # failed: hit + miss keeps reconciling with the request totals.
        self.metrics.cache_misses.inc()
        return command, result

    def cache_key(self, sanitized_query: str) -> str:
        """The response-cache key of one request. Under GRAMMAR_DECODE
        it is scoped by the request's grammar identity (clamped profile
        and allowed verbs): keyed by the query alone, a mutating command
        cached for an interactive tenant would be served verbatim to a
        readonly-clamped one. Off, the key is the plain query."""
        if not self.cfg.grammar_decode:
            return sanitized_query
        qctx = current_qos()
        return sanitized_query + cache_scope(
            self.cfg.grammar_profile,
            qctx.lane if qctx is not None else None, current_grammar())

    async def generate_command(
        self, sanitized_query: str
    ) -> Tuple[str, bool, Optional[EngineResult], bool]:
        """Cache-or-generate; returns (command, from_cache, engine_result,
        degraded). Engine failures (breaker-open fast fails included)
        degrade to the rule table when DEGRADED_FALLBACK is set; overload
        sheds, quarantines, unsafe outputs and bugs always propagate."""
        last_result: list = [None]

        async def supplier() -> str:
            prompt = render_prompt(sanitized_query)
            result = await self.run_engine(lambda: self.engine.generate(
                prompt,
                max_tokens=self.cfg.max_new_tokens,
                temperature=self.cfg.temperature,
                timeout=self.cfg.llm_timeout,
            ))
            last_result[0] = result
            with span("safety"):
                command = parse_llm_output(result.text)
            logger.info("Engine generated command for query '%s': %s",
                        sanitized_query, command)
            return command

        try:
            command, from_cache = await self.cache.get_or_create(
                self.cache_key(sanitized_query), supplier)
        except EngineOverloaded:
            raise
        except (EngineUnavailable, GenerationTimeout,
                asyncio.TimeoutError) as e:
            if self.fallback is None:
                raise
            command, result = await self.degraded_command(sanitized_query, e)
            return command, False, result, True
        if from_cache:
            self.metrics.cache_hits.inc()
        else:
            self.metrics.cache_misses.inc()
        return command, from_cache, last_result[0], False
