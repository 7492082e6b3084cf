"""Engine selection from config.

``ENGINE=torch`` serves through the continuous-batching engine when
``DECODE_BATCH_SIZE`` > 1 (the default) and through the single-sequence
engine (``engine/torch_engine.py::TorchEngine``: dense cache, flash
prefill) at 1 — the JAX factory's rule; ``ENGINE=torch-batched`` always
batches. Both take ``QUANT``, ``KV_QUANT`` and ``MOE_IMPL``
(``engine_kwargs``). ``ENGINE=openai`` calls an OpenAI-compatible
ChatCompletions endpoint (``engine/openai_compat.py``), and
``ENGINE=fake`` answers from the rule table (``engine/fake.py::
FakeEngine``: no model, no device).

``FLEET_SIZE`` > 1 builds that many engines behind the
``engine/fleet.py::EngineFleet`` facade (``_build_fleet``, the JAX
factory's): each replica is a whole engine with its own weights and KV,
and all of them may share one card.

``FAULT_POINTS`` is parsed before the engine is built, outside the
degraded-start net, as the JAX factory does: a typo'd drill refuses to
boot instead of starting into what looks like a real outage. One
injector serves the batcher's points and the ``generate`` wrapper
(``ChaosEngine``), so ``fired()``, ``release()`` and ``clear()`` see
every point; each fleet replica gets its replica-scoped view
(``for_replica``), so ``r1:scheduler:die`` fires in replica 1 only. A
point the selected engine can never fire is refused at boot: the
batcher's points (``swap`` and ``checkpoint`` among them) under another
engine, ``draft:die`` without ``SPEC_DECODE=true`` (the JAX factory lets
that drill sit inert), a replica scope at or beyond ``FLEET_SIZE``, a
replica-scoped ``generate`` (its wrapper sits above the fleet), and
``offload`` and ``onload`` without the host tier (``HOST_KV_BLOCKS`` >
0). ``FLEET_SIZE`` > 1 with ``ENGINE=openai`` is refused as the JAX
factory refuses it.

On a construction failure the service starts degraded and answers 503
(as the JAX factory does): a misconfiguration keeps ``/health`` up and
explains itself instead of taking the process down.
"""

from __future__ import annotations

import logging

from ..engine.protocol import EngineResult, EngineUnavailable

logger = logging.getLogger(__name__)

#: the points only the continuous-batching engine checks
BATCHER_POINTS = ("admit", "chunk", "decode", "scheduler", "tenant",
                  "draft", "swap", "checkpoint", "offload", "onload")

#: the points of the two-tier host KV: its demote and onload paths
HOST_TIER_POINTS = ("offload", "onload")


class DegradedEngine:
    """Placeholder engine when construction failed: 503 on every call."""

    name = "degraded"
    ready = False
    device = None

    def __init__(self, reason: str):
        self.reason = reason

    async def start(self) -> None:
        logger.error("Engine degraded: %s", self.reason)

    async def stop(self, drain_secs: float = 0.0) -> None:
        pass

    async def generate(self, prompt, **kw) -> EngineResult:
        raise EngineUnavailable(self.reason)

    async def generate_stream(self, prompt, **kw):
        # Raises before the first piece, so the stream route answers
        # with its engine-unavailable frame (or the degraded fallback).
        raise EngineUnavailable(self.reason)
        yield  # pragma: no cover - makes this an async generator


def parse_fault_points(cfg):
    """The one shared injector of ``FAULT_POINTS`` (None when empty), or
    ValueError for a drill that is malformed or could never fire."""
    from ..testing.faults import FaultInjector

    injector = FaultInjector.from_spec(cfg.fault_points)
    if injector is None:
        return None
    needs_batcher = [p for p in BATCHER_POINTS if injector.has_any(p)]
    if needs_batcher and not cfg.batched_engine:
        raise ValueError(
            f"FAULT_POINTS {needs_batcher} are only wired into the "
            "continuous-batching engine (ENGINE=torch with "
            f"DECODE_BATCH_SIZE>1); inert under ENGINE={cfg.engine!r}")
    if injector.has_any("draft") and not cfg.spec_decode:
        raise ValueError(
            "FAULT_POINTS 'draft' kills the speculative-decode draft, "
            "which runs only with SPEC_DECODE=true; the drill would be "
            "inert")
    host_points = [p for p in HOST_TIER_POINTS if injector.has_any(p)]
    if host_points and cfg.host_kv_blocks <= 0:
        raise ValueError(
            f"FAULT_POINTS {host_points} drill the two-tier host KV "
            "(ROADMAP.md A7 row 5), which runs only with HOST_KV_BLOCKS>0; "
            "the drill would be inert")
    scoped = injector.scoped_replicas()
    if scoped and max(scoped) >= cfg.fleet_size:
        raise ValueError(
            f"FAULT_POINTS names replica(s) {sorted(scoped)} but "
            f"FLEET_SIZE={cfg.fleet_size}; the drill would be inert")
    if injector.has_any("generate") and not injector.has("generate"):
        raise ValueError(
            "FAULT_POINTS: 'generate' faults cannot be replica-scoped "
            "(the generate-path wrapper sits above the fleet); drop the "
            "r<idx>: prefix")
    return injector


def _build_inner(cfg, faults, devices=None):
    if cfg.engine == "fake":
        from ..engine.fake import FakeEngine

        return FakeEngine()
    if cfg.engine == "openai":
        from ..engine.openai_compat import OpenAICompatEngine

        return OpenAICompatEngine(api_key=cfg.openai_api_key,
                                  model=cfg.openai_model,
                                  base_url=cfg.openai_base_url,
                                  timeout=cfg.llm_timeout)
    if cfg.batched_engine:
        from ..engine.batcher import BatchedTorchEngine

        return BatchedTorchEngine.from_config(cfg, faults=faults,
                                              devices=devices)
    from ..engine.torch_engine import TorchEngine

    return TorchEngine.from_config(cfg, devices=devices)


def _build_fleet(cfg, injector):
    """``FLEET_SIZE`` > 1: the replicas behind the ``EngineFleet``
    facade. Each replica gets a replica-scoped view of the one shared
    injector, so an ``r0:scheduler:die`` drill hits exactly the replica
    it names while the counters stay on one ledger."""
    from ..engine.fleet import EngineFleet

    replicas = [_build_inner(cfg, injector.for_replica(i)
                             if injector is not None else None)
                for i in range(cfg.fleet_size)]
    return EngineFleet(
        replicas,
        hedge_ms=cfg.fleet_hedge_ms,
        affinity=cfg.fleet_affinity,
        migration_budget=cfg.fleet_migration_budget,
        rejoin_secs=cfg.fleet_rejoin_secs,
        drain_secs=cfg.drain_timeout_secs,
        breaker_threshold=cfg.breaker_threshold,
        breaker_window_secs=cfg.breaker_window_secs,
        breaker_recovery_secs=cfg.breaker_recovery_secs,
    )


def build_engine(cfg, devices=None):
    """The engine ``cfg`` names (``devices``: the mesh's devices of this
    process, one per shard, when they are not the distinct cards)."""
    injector = parse_fault_points(cfg)
    if cfg.fleet_size > 1 and cfg.engine == "openai":
        # Outside the degraded-start net, as in the JAX factory: N
        # clients of one remote endpoint are not a fleet.
        raise ValueError("FLEET_SIZE > 1 requires a local engine "
                         "(ENGINE=torch | torch-batched | fake)")
    try:
        if cfg.fleet_size > 1:
            engine = _build_fleet(cfg, injector)
        else:
            # The single engine is replica 0: an "r0:" drill gets the
            # replica-0 view, an unscoped one the injector itself (the
            # one object the generate wrapper shares).
            faults = injector
            if injector is not None and injector.scoped_replicas():
                faults = injector.for_replica(0)
            engine = _build_inner(cfg, faults, devices)
        if injector is not None and injector.has("generate"):
            from ..testing.faults import ChaosEngine

            logger.warning("FAULT_POINTS active on the generate path: %s",
                           injector.describe())
            return ChaosEngine(engine, injector)
        return engine
    except Exception as e:
        logger.exception("Failed to initialize engine; starting degraded.")
        return DegradedEngine(f"engine init failed: {e}")
