"""Engine fleet: replicated engines behind one ``Engine``-protocol facade
(a copy of the JAX package's ``engine/fleet.py``).

The ``EngineFleet`` runs N engine replicas (``BatchedTorchEngine``s
from ``FLEET_SIZE``, which may share one card; anything speaking the
Engine protocol works, with degraded capabilities) behind a front router
and escalates the engine's containment machinery from slot level to
replica level. Four mechanisms:

1. **Health-aware routing** — every dispatch picks a replica by live
   signals only: replica state (active / draining / ejected), engine
   readiness, the per-replica circuit breaker, and in-flight occupancy
   (least-loaded wins). A :class:`PrefixAffinity` map keeps multi-turn
   ``/execute`` agent loops — whose next prompt extends the previous
   prompt + completion — on the replica already holding their KV prefix
   (a cache-aware front scheduler, approximated with an LRU of
   ``(prefix_len, crc32)`` keys instead of a radix tree).
2. **Hedged re-dispatch** — when the chosen replica produces no event
   within ``FLEET_HEDGE_MS``, the same request (same seed, same resume
   prefix) is dispatched to a second replica and whichever branch yields
   first wins; the loser is cancelled. Per-request seeded sampling makes
   the two transcripts identical, so winner choice can never change
   client-visible bytes.
3. **Cross-replica migration** — the fleet-level reset-and-replay. Each
   request's recoverable state is the portable (prompt, generated-prefix
   ids, seed) tuple (protocol.RequestExport, kept live by the engine
   scheduler). When a replica fails mid-request — engine stopped, reset
   budget exhausted, watchdog trip, scheduler death past recovery — the
   request is re-submitted to a healthy replica with ``resume_ids``: the
   engine re-splices prompt + prefix via one prefill (the containment replay
   path) and the continuation is bit-identical. The relay suppresses the
   re-emitted prefix, so a client holding an open SSE stream sees a
   seamless byte-identical continuation. Engines without resume support
   simply replay from scratch under the same seed (same bytes, more
   compute) — the suppression logic is identical either way.
4. **Zero-downtime drains** — ``drain(replica)`` takes a replica out of
   rotation, nudges its in-flight requests to migrate (voluntarily, via
   the same path as crash failover), waits them out, and stops the
   engine; ``rejoin(replica)`` restarts it with a clean breaker. An
   ejected-then-rejoined replica cycles without dropping a request —
   the rolling-restart story (process SIGTERM still drains the whole
   fleet through ``stop(drain_secs)``, server/__main__.py).

The fleet is deliberately an *engine*, not a service: everything above
the Engine seam (breaker, cache, middleware) works unchanged, and the
service-level breaker stays the outer ring for fleet-wide failures.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import logging
import time
import zlib
from collections import OrderedDict, deque
from typing import AsyncIterator, Dict, List, Optional, Sequence, Set, Tuple

from ..obs import ledger as obs_ledger
from ..obs import slo as obs_slo
from ..obs import steptime as obs_steptime
from ..obs.ledger import CLASS_HEDGE_LOSER, GoodputLedger
from ..obs.trace import current_trace
from ..server.breaker import OPEN, CircuitBreaker
from .protocol import (EngineOverloaded, EngineResult, EngineUnavailable,
                       GenerationTimeout, RequestExport, RequestQuarantined)
from .qos import LANE_INTERACTIVE, LANES, current_qos, lane_rank

logger = logging.getLogger(__name__)

#: replica lifecycle states (the /health + metrics label set — fixed here
#: so cardinality is bounded by construction).
REPLICA_ACTIVE = "active"
REPLICA_DRAINING = "draining"
REPLICA_EJECTED = "ejected"
REPLICA_STATES = (REPLICA_ACTIVE, REPLICA_DRAINING, REPLICA_EJECTED)


class PrefixAffinity:
    """Prefix-keyed session affinity for multi-turn agent loops.

    A turn-N prompt in the ``/execute`` agent loop is turn N-1's prompt
    plus its completion plus the new user turn — a pure prefix
    extension. Full radix-tree matching is overkill for a
    router hint, so entries are ``(prefix_len, crc32(prefix)) →
    replica`` in an LRU: recorded at dispatch (the prompt itself) and at
    completion (prompt + generated text, the KV the replica now holds);
    lookup probes the recorded lengths ≤ ``len(prompt)`` longest-first
    and returns the first replica whose recorded prefix matches. False
    positives need a crc32 collision at equal length — harmless (a
    mis-routed request still serves correctly, it just misses the warm
    prefix)."""

    def __init__(self, maxsize: int = 2048, max_probe: int = 16):
        self.maxsize = maxsize
        self.max_probe = max_probe
        self._map: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        self._lengths: Dict[int, int] = {}   # refcount per recorded length

    @staticmethod
    def _crc(text: str) -> int:
        return zlib.crc32(text.encode("utf-8", "surrogatepass"))

    def record(self, text: str, replica: int) -> None:
        if not text:
            return
        key = (len(text), self._crc(text))
        if key not in self._map:
            self._lengths[len(text)] = self._lengths.get(len(text), 0) + 1
        self._map[key] = replica
        self._map.move_to_end(key)
        while len(self._map) > self.maxsize:
            (length, _), _ = self._map.popitem(last=False)
            n = self._lengths.get(length, 0) - 1
            if n <= 0:
                self._lengths.pop(length, None)
            else:
                self._lengths[length] = n

    def lookup(self, text: str) -> Optional[int]:
        """Replica that holds the longest recorded prefix of ``text``."""
        lengths = sorted((ln for ln in self._lengths if ln <= len(text)),
                         reverse=True)[:self.max_probe]
        for ln in lengths:
            key = (ln, self._crc(text[:ln]))
            rep = self._map.get(key)
            if rep is not None:
                self._map.move_to_end(key)
                return rep
        return None

    def forget_replica(self, replica: int) -> None:
        """Drop every entry pointing at ``replica`` (its KV is gone —
        ejected/drained replicas must not keep attracting sessions)."""
        dead = [k for k, v in self._map.items() if v == replica]
        for key in dead:
            del self._map[key]
            n = self._lengths.get(key[0], 0) - 1
            if n <= 0:
                self._lengths.pop(key[0], None)
            else:
                self._lengths[key[0]] = n


@dataclasses.dataclass(eq=False)   # identity hash: flights live in sets
class _Flight:
    """One in-flight fleet request, registered with the replica serving
    it so ``drain()`` can nudge it to migrate. ``lane`` (QoS ring) lets
    drains evict background work first and the router count only the
    occupancy a given lane actually contends with."""

    migrate: asyncio.Event = dataclasses.field(default_factory=asyncio.Event)
    lane: str = LANE_INTERACTIVE


class _Replica:
    """One engine replica + its routing signals."""

    def __init__(self, idx: int, engine, breaker: CircuitBreaker):
        self.idx = idx
        self.engine = engine
        self.state = REPLICA_ACTIVE
        self.breaker = breaker
        self.inflight = 0            # fleet relays currently dispatched here
        self.flights: Set[_Flight] = set()
        self.eject_cause: Optional[str] = None
        self.last_error: str = ""
        self.migrations_out = 0      # requests migrated OFF this replica
        self.dispatches = 0          # cumulative fleet dispatches landed
        self.not_ready_since: Optional[float] = None

    def weights_version(self) -> str:
        """The checkpoint version this replica's engine serves — the
        pin key for migration/hedge/replay routing and the
        per-replica /health stamp. "" for engines without versioning."""
        return str(getattr(self.engine, "weights_version", "") or "")

    def occupancy(self) -> int:
        """Cheap slot occupancy (never calls stats() — stats drains the
        fetch-latency samples owed to the /metrics scrape)."""
        slots = getattr(self.engine, "_slots", None)
        if slots:
            return sum(s is not None for s in slots)
        return self.inflight

    def occupancy_for(self, lane: Optional[str]) -> int:
        """Lane-aware occupancy (QoS ring): slots a request at ``lane``
        actually contends with — lower-lane slots are preemptible, so a
        replica full of background work is still routable for
        interactive traffic."""
        fn = getattr(self.engine, "lane_occupancy", None)
        if lane is None or not callable(fn):
            return self.occupancy()
        rank = lane_rank(lane)
        return sum(n for la, n in fn().items() if lane_rank(la) >= rank)

    def inflight_for(self, lane: Optional[str]) -> int:
        """Fleet relays dispatched here at or above ``lane``."""
        if lane is None:
            return self.inflight
        rank = lane_rank(lane)
        return sum(1 for f in self.flights
                   if lane_rank(getattr(f, "lane", LANE_INTERACTIVE))
                   >= rank)


class EngineFleet:
    """N engine replicas behind one Engine-protocol facade."""

    name = "fleet"

    #: monitor poll interval and how long a replica must read not-ready
    #: before ejection (debounces the watchdog's transient re-arm).
    MONITOR_INTERVAL = 0.05
    EJECT_GRACE_SECS = 0.2
    #: affinity is honoured unless the preferred replica is this many
    #: in-flight requests busier than the least-loaded candidate —
    #: cache locality is worth a little imbalance, not a hot spot.
    AFFINITY_SLACK = 4

    #: drain-rate freshness horizon for retry_after_hint (same semantics
    #: as the batcher's).
    DRAIN_RATE_HORIZON_SECS = 60.0

    def __init__(self, replicas: Sequence, *,
                 hedge_ms: float = 0.0,
                 affinity: bool = True,
                 migration_budget: int = 3,
                 rejoin_secs: float = 0.0,
                 drain_secs: float = 10.0,
                 breaker_threshold: int = 5,
                 breaker_window_secs: float = 30.0,
                 breaker_recovery_secs: float = 15.0):
        if not replicas:
            raise ValueError("fleet needs at least one replica")
        self.hedge_ms = max(0.0, hedge_ms)
        self.migration_budget = max(0, migration_budget)
        self.rejoin_secs = max(0.0, rejoin_secs)
        self.drain_secs_default = max(0.0, drain_secs)
        self._breaker_kw = dict(threshold=breaker_threshold,
                                window_secs=breaker_window_secs,
                                recovery_secs=breaker_recovery_secs)
        self.replicas: List[_Replica] = [
            _Replica(i, eng, CircuitBreaker(**self._breaker_kw))
            for i, eng in enumerate(replicas)
        ]
        self.affinity: Optional[PrefixAffinity] = (
            PrefixAffinity() if affinity else None)
        # Weight rollout: while a canary is set, the router
        # steers a bounded fraction of FRESH traffic at it via a share
        # accumulator (exact over any request count, no RNG); while a
        # swap is in flight (swap_hint > 0) a no-replica moment sheds
        # with a priced 503 instead of a bare EngineUnavailable.
        self._canary_idx: Optional[int] = None
        self._canary_share = 0.0
        self._canary_acc = 0.0
        self.swap_hint = 0.0
        self._stopping = False
        self._monitor_task: Optional[asyncio.Task] = None
        self._rejoin_tasks: Set[asyncio.Task] = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._reset_listener = None
        # Fleet counters (cumulative; /metrics delta-mirrors them).
        self._migrations = 0
        self._migrated_tokens = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._drains = 0
        self._ejects = 0
        self._rejoins = 0
        self._finish_times: deque = deque(maxlen=128)
        # Goodput ledger: the fleet's OWN ledger holds the one
        # class only the relay can see — hedge_loser steps, billed when
        # a losing branch is cancelled. Replica engines bill everything
        # else; ledger_snapshot()/stats() merge all of them.
        self.ledger = GoodputLedger()
        # Inner ring → fleet ring: each replica supervisor's resets feed
        # that replica's breaker (a flapping replica leaves rotation even
        # while its own containment keeps recovering requests) and are
        # forwarded to the service listener for the outer breaker.
        for rep in self.replicas:
            hook = getattr(rep.engine, "set_reset_listener", None)
            if callable(hook):
                hook(self._make_reset_hook(rep))

    def _make_reset_hook(self, rep: _Replica):
        def on_reset(cause: str, _rep=rep) -> None:
            self._on_replica_reset(_rep, cause)
        return on_reset

    def _on_replica_reset(self, rep: _Replica, cause: str) -> None:
        """Called from the replica's scheduler thread after each engine
        reset: marshal onto the event loop (breaker transitions are
        loop-only by design) and forward to the service layer."""
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(rep.breaker.record_failure)
        else:  # pragma: no cover - pre-traffic reset
            rep.breaker.record_failure()
        listener = self._reset_listener
        if listener is not None:
            try:
                listener(cause)
            except Exception:  # pragma: no cover - listener is best-effort
                pass

    def set_reset_listener(self, fn) -> None:
        """Service-layer hook (the service breaker): fleet aggregation of
        every replica's reset stream."""
        self._reset_listener = fn

    # ----------------------------------------------------------- lifecycle

    @property
    def ready(self) -> bool:
        return (not self._stopping
                and any(rep.state == REPLICA_ACTIVE
                        and getattr(rep.engine, "ready", False)
                        for rep in self.replicas))

    async def start(self) -> None:
        self._stopping = False
        self._loop = asyncio.get_running_loop()
        results = await asyncio.gather(
            *(rep.engine.start() for rep in self.replicas),
            return_exceptions=True)
        failures = []
        for rep, res in zip(self.replicas, results):
            if isinstance(res, BaseException):
                rep.state = REPLICA_EJECTED
                rep.eject_cause = "start_failed"
                rep.last_error = f"{type(res).__name__}: {res}"
                failures.append((rep.idx, res))
                logger.error("fleet: replica %d failed to start: %s",
                             rep.idx, res)
        if len(failures) == len(self.replicas):
            raise failures[0][1]
        if failures:
            logger.warning("fleet: serving with %d/%d replicas",
                           len(self.replicas) - len(failures),
                           len(self.replicas))
        self._monitor_task = asyncio.create_task(self._monitor())

    async def stop(self, drain_secs: float = 0.0) -> None:
        """Whole-fleet shutdown (process SIGTERM): every replica drains
        in place — in-flight requests FINISH where they run (migrating
        between two dying replicas would be churn, not progress) while
        new submissions 503 so the LB drains us."""
        self._stopping = True
        if self._monitor_task is not None:
            self._monitor_task.cancel()
            try:
                await self._monitor_task
            except (asyncio.CancelledError, Exception):
                pass
            self._monitor_task = None
        for t in list(self._rejoin_tasks):
            t.cancel()
        self._rejoin_tasks.clear()
        await asyncio.gather(
            *(rep.engine.stop(drain_secs=drain_secs)
              for rep in self.replicas),
            return_exceptions=True)

    async def _monitor(self) -> None:
        """Replica-death detection: an active replica whose engine reads
        not-ready past a short grace (watchdog trip, reset budget
        exhausted, scheduler dead terminally) is ejected from rotation;
        its in-flight requests migrate via the per-request relay. With
        ``FLEET_REJOIN_SECS`` set, a restart is attempted after that
        delay (crash-looping replicas stay ejected — each rejoin needs a
        successful engine start)."""
        while True:
            await asyncio.sleep(self.MONITOR_INTERVAL)
            now = time.monotonic()
            for rep in self.replicas:
                if rep.state != REPLICA_ACTIVE:
                    continue
                if getattr(rep.engine, "ready", False):
                    rep.not_ready_since = None
                    continue
                if rep.not_ready_since is None:
                    rep.not_ready_since = now
                    continue
                if now - rep.not_ready_since >= self.EJECT_GRACE_SECS:
                    # Fleet escalation of the containment policy: an
                    # engine whose supervisor recently DENIED a reset
                    # (budget spent — it stopped recovering by design)
                    # gets an attributable eject cause; operators treat
                    # "reset_budget_exhausted" as replace-the-replica,
                    # not a transient flap.
                    cause = "not_ready"
                    sup = getattr(rep.engine, "supervisor", None)
                    denial = getattr(sup, "last_denial_wall", None)
                    if denial and time.time() - denial < 120.0:
                        cause = "reset_budget_exhausted"
                    self.eject(rep.idx, cause=cause)
                    if self.rejoin_secs > 0:
                        task = asyncio.create_task(self._auto_rejoin(rep))
                        self._rejoin_tasks.add(task)
                        task.add_done_callback(self._rejoin_tasks.discard)

    async def _auto_rejoin(self, rep: _Replica) -> None:
        await asyncio.sleep(self.rejoin_secs)
        try:
            await self.rejoin(rep.idx)
        except Exception as e:  # pragma: no cover - engine-dependent
            rep.last_error = f"rejoin failed: {e}"
            logger.exception("fleet: replica %d rejoin failed", rep.idx)

    def eject(self, idx: int, cause: str = "manual") -> None:
        """Take a replica out of rotation NOW. In-flight requests are
        nudged to migrate; queued routing never picks it again until
        ``rejoin``."""
        rep = self.replicas[idx]
        if rep.state == REPLICA_EJECTED:
            return
        rep.state = REPLICA_EJECTED
        rep.eject_cause = cause
        rep.not_ready_since = None
        self._ejects += 1
        if self.affinity is not None:
            self.affinity.forget_replica(idx)
        logger.warning("fleet: replica %d ejected (%s); %d in-flight "
                       "request(s) migrating", idx, cause, len(rep.flights))
        # Lowest lane first (QoS): on a crash-eject everyone migrates
        # this tick anyway, but the ordering keeps background's
        # re-splice load ahead of interactive's on the receiving side.
        for flight in sorted(
                rep.flights,
                key=lambda f: lane_rank(getattr(f, "lane", None))):
            flight.migrate.set()

    async def drain(self, idx: int,
                    drain_secs: Optional[float] = None) -> None:
        """Zero-downtime voluntary drain of one replica: out of rotation,
        in-flight requests migrate to healthy replicas (same re-splice
        path as crash failover — nothing waits for generations to end),
        then the engine stops. Pair with ``rejoin`` for a rolling
        restart that drops nothing."""
        rep = self.replicas[idx]
        drain_secs = (self.drain_secs_default if drain_secs is None
                      else max(0.0, drain_secs))
        if rep.state == REPLICA_ACTIVE:
            rep.state = REPLICA_DRAINING
            self._drains += 1
            if self.affinity is not None:
                self.affinity.forget_replica(idx)
        logger.info("fleet: draining replica %d (%d in-flight)",
                    idx, len(rep.flights))
        # Version-pinned migration: a nudged flight can only
        # re-splice onto a replica serving the SAME weights — so the
        # nudge targets are same-version siblings, and when none exist
        # (last replica, or last replica on the outgoing version during
        # a rollout promote) in-flight work finishes in place instead of
        # being aborted into unroutable migrations.
        v = rep.weights_version()
        targets = [r for r in self._routable()
                   if not v or r.weights_version() == v]
        if targets:
            # QoS eviction order: background (and batch) migrate FIRST;
            # interactive flights keep decoding here until the lower
            # lanes have re-seated (or a slice of the budget passes) so
            # the sibling absorbs the bulk re-splices before the
            # latency-sensitive ones arrive.
            lower = [f for f in rep.flights
                     if lane_rank(getattr(f, "lane", None))
                     < lane_rank(LANE_INTERACTIVE)]
            for flight in sorted(
                    lower, key=lambda f: lane_rank(getattr(f, "lane",
                                                           None))):
                flight.migrate.set()
            if lower:
                stage_deadline = time.monotonic() + min(
                    1.0, drain_secs * 0.25)
                while (any(f in rep.flights for f in lower)
                       and time.monotonic() < stage_deadline):
                    await asyncio.sleep(0.01)
            for flight in list(rep.flights):
                flight.migrate.set()
        elif rep.flights:
            # No same-version migration target (last routable replica,
            # or the last replica on this weights version): a nudge
            # would abort every in-flight request into "no healthy
            # replica" errors. Let them finish in place on this replica
            # within the drain budget instead — same finish-in-place
            # semantics as whole-fleet stop().
            logger.warning(
                "fleet: no same-version migration target while draining "
                "replica %d; letting %d in-flight requests finish in "
                "place", idx, len(rep.flights))
        deadline = time.monotonic() + drain_secs
        while rep.flights and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        await rep.engine.stop(
            drain_secs=max(0.0, deadline - time.monotonic()))
        rep.state = REPLICA_EJECTED
        rep.eject_cause = "drain"

    async def rejoin(self, idx: int) -> None:
        """Restart an ejected/drained replica and return it to rotation
        with a clean breaker."""
        rep = self.replicas[idx]
        if rep.state == REPLICA_ACTIVE and getattr(rep.engine, "ready",
                                                   False):
            # Genuinely healthy — nothing to do. A replica whose engine
            # was hard-killed but which the monitor has not yet ejected
            # (debounce) is still state=active with ready=False: the
            # early return used to skip the restart entirely there,
            # leaving a dead engine "active" until the monitor caught
            # up — a rejoin racing the eject must restart it anyway.
            return
        if not getattr(rep.engine, "ready", False):
            try:
                # Idempotent cleanup for engines ejected mid-flight
                # (watchdog/reset-budget paths leave threads behind).
                await rep.engine.stop()
            except Exception:  # pragma: no cover - engine-dependent
                pass
            await rep.engine.start()
        rep.breaker = CircuitBreaker(**self._breaker_kw)
        rep.state = REPLICA_ACTIVE
        rep.eject_cause = None
        rep.not_ready_since = None
        rep.last_error = ""
        self._rejoins += 1
        logger.info("fleet: replica %d rejoined", idx)

    # ------------------------------------------------------- weight rollout

    @property
    def weights_version(self) -> str:
        """The STABLE version the fleet serves: the most common version
        among active non-canary replicas (falling back to any replica)
        — what /health's top level and X-Model-Version echo."""
        counts: Dict[str, int] = {}
        for rep in self.replicas:
            if rep.state == REPLICA_ACTIVE and rep.idx != self._canary_idx:
                v = rep.weights_version()
                if v:
                    counts[v] = counts.get(v, 0) + 1
        if not counts:
            for rep in self.replicas:
                v = rep.weights_version()
                if v:
                    counts[v] = counts.get(v, 0) + 1
        if not counts:
            return ""
        return max(sorted(counts), key=lambda v: counts[v])

    def set_canary(self, idx: int, share: float) -> None:
        """Steer ``share`` of fresh traffic at replica ``idx`` (the
        rollout controller's observe phase). Clamped to at most half —
        the canary must never be able to starve the stable cohort's
        interactive lane."""
        self._canary_idx = int(idx)
        self._canary_share = min(max(0.0, float(share)), 0.5)
        self._canary_acc = 0.0

    def clear_canary(self) -> None:
        self._canary_idx = None
        self._canary_share = 0.0
        self._canary_acc = 0.0

    # ------------------------------------------------------------- routing

    def _routable(self, exclude: Sequence[int] = ()) -> List[_Replica]:
        return [
            rep for rep in self.replicas
            if rep.idx not in exclude
            and rep.state == REPLICA_ACTIVE
            and getattr(rep.engine, "ready", False)
            and rep.breaker.state != OPEN
        ]

    def _route(self, prompt: str, exclude: Sequence[int] = (),
               lane: Optional[str] = None,
               version: Optional[str] = None) -> Optional[_Replica]:
        """Health-aware pick: least-loaded among routable replicas,
        overridden by prefix affinity unless the preferred replica is
        more than AFFINITY_SLACK requests busier. With ``lane`` set the
        load keys are lane-aware (QoS ring): only in-flight work at or
        above the request's lane counts, so a replica whose slots are
        all preemptible background work routes like an idle one for
        interactive traffic.

        Weight rollout: ``version`` pins the pick to
        replicas serving exactly that checkpoint — an established
        stream's re-splice cannot be byte-identical across weights, so
        a version-mismatched candidate is simply not a candidate (None
        when no same-version replica is routable; the caller decides
        what that means). Fresh traffic (``version=None``) is subject
        to canary steering instead: the share accumulator sends the
        canary its bounded fraction and keeps the rest on the stable
        cohort."""
        cands = self._routable(exclude)
        if not cands:
            return None
        if version is not None:
            cands = [r for r in cands if r.weights_version() == version]
            if not cands:
                return None
        elif self._canary_idx is not None:
            canary = next((r for r in cands
                           if r.idx == self._canary_idx), None)
            others = [r for r in cands if r.idx != self._canary_idx]
            if canary is not None and others:
                self._canary_acc += self._canary_share
                if self._canary_acc >= 1.0:
                    self._canary_acc -= 1.0
                    if self.affinity is not None:
                        self.affinity.record(prompt, canary.idx)
                    return canary
                # Stable traffic stays off the canary — without this the
                # canary's least-loaded idleness would attract far more
                # than its bounded share.
                cands = others
            # canary-only candidates: availability beats the share bound.
        best = min(cands, key=lambda r: (r.inflight_for(lane),
                                         r.occupancy_for(lane),
                                         r.inflight, r.idx))
        if self.affinity is not None:
            want = self.affinity.lookup(prompt)
            if want is not None and want != best.idx:
                for rep in cands:
                    if (rep.idx == want
                            and rep.inflight
                            <= best.inflight + self.AFFINITY_SLACK):
                        best = rep
                        break
            self.affinity.record(prompt, best.idx)
        return best

    # --------------------------------------------------------------- relay

    async def _replica_events(self, rep: _Replica, *, prompt: str,
                              max_tokens: int, temperature: float,
                              timeout: Optional[float], seed: int,
                              resume_ids: Optional[List[int]],
                              export: RequestExport):
        """One dispatch on one replica, normalized to (event, payload).

        Engines exposing ``stream_events`` (the chunked schedulers) get
        the full contract — seed pinning, resume import, live export.
        Anything else speaking only the base Engine protocol is driven
        through ``generate`` (full EngineResult fidelity; its text
        arrives as one token event and migration replays from scratch —
        prefix suppression keeps the client bytes identical)."""
        fn = getattr(rep.engine, "stream_events", None)
        if fn is not None:
            async for ev in fn(prompt, max_tokens=max_tokens,
                               temperature=temperature, timeout=timeout,
                               seed=seed, resume_ids=resume_ids,
                               export=export):
                yield ev
            return
        kw = dict(max_tokens=max_tokens, temperature=temperature,
                  timeout=timeout)
        try:
            # Pin the fleet-minted seed when the engine supports it —
            # hedge races and replay-from-scratch migrations depend on
            # two dispatches producing the SAME bytes. (Base-protocol
            # engines without a seed param are rule-deterministic.)
            if "seed" in inspect.signature(rep.engine.generate).parameters:
                kw["seed"] = seed
        except (TypeError, ValueError):  # pragma: no cover - exotic impls
            pass
        result = await rep.engine.generate(prompt, **kw)
        if result.text:
            yield ("token", result.text)
        yield ("done", result)

    async def _pump(self, tag: int, rep: _Replica, q: asyncio.Queue,
                    **kw) -> None:
        """Drive one branch's event stream into the shared queue. Errors
        travel in-band; cancellation closes the engine generator (which
        aborts the slot — the engine's documented disconnect path)."""
        try:
            async for ev in self._replica_events(rep, **kw):
                q.put_nowait((tag, "ev", ev))
            q.put_nowait((tag, "end", None))
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            q.put_nowait((tag, "err", e))

    @staticmethod
    def _is_migratable(e: BaseException) -> bool:
        """Replica-infrastructure failures migrate; request-level
        verdicts don't. Quarantine is terminal BY DESIGN (a poisonous
        request re-splice would just poison the next replica); timeouts
        are the request's own deadline; overload is handled separately
        (reroute, not migration)."""
        if isinstance(e, (RequestQuarantined, GenerationTimeout,
                          EngineOverloaded)):
            return False
        return isinstance(e, EngineUnavailable)

    async def _stream_events(self, prompt: str, *, max_tokens: int = 128,
                             temperature: float = 0.0,
                             timeout: Optional[float] = None,
                             seed: Optional[int] = None):
        """The fleet relay: route → dispatch (hedged) → re-emit events,
        migrating across replicas on infrastructure failure or drain
        nudge with the already-delivered prefix suppressed."""
        if self._stopping:
            raise EngineUnavailable("fleet stopping")
        if seed is None:
            seed = zlib.crc32(
                prompt.encode("utf-8", "surrogatepass")) & 0x7FFFFFFF
        seed = int(seed) & 0x7FFFFFFF
        deadline = (time.monotonic() + timeout) if timeout else None
        trace = current_trace()
        # QoS lane rides the same contextvar the engines read; the fleet
        # uses it for lane-aware routing and drain-eviction ordering.
        qctx = current_qos()
        flight = _Flight(lane=(qctx.lane if qctx is not None
                               and qctx.lane in LANES
                               else LANE_INTERACTIVE))
        delivered = ""               # text already yielded to the caller
        export_ids: List[int] = []   # best-known generated prefix (ids)
        migrations = 0
        exclude: List[int] = []
        last_err: Optional[BaseException] = None
        overload_tried: List[int] = []
        # Weight rollout: the checkpoint version that
        # generated this stream's prefix. An ESTABLISHED stream (any
        # generated ids or delivered bytes) only routes to same-version
        # replicas — a cross-version re-splice cannot be byte-identical
        # — while a fresh request routes freely and, after a failed
        # fresh dispatch, replays from scratch on whatever version it
        # lands on (pin re-stamps per attempt).
        pinned: Optional[str] = None

        while True:
            established = bool(delivered) or bool(export_ids)
            want = pinned if (pinned and established) else None
            rep = self._route(prompt, exclude=exclude + overload_tried,
                              lane=flight.lane, version=want)
            if rep is None:
                if isinstance(last_err, EngineOverloaded):
                    # Every routable replica shed: propagate, re-priced
                    # from the FLEET-wide drain rate (a single replica's
                    # estimate undersells N replicas draining). The
                    # CLASS is preserved — a per-tenant 429
                    # (TenantOverloaded) must stay a 429 through the
                    # fleet, not dilute into everyone's 503.
                    raise type(last_err)(
                        str(last_err),
                        retry_after=self.retry_after_hint())
                if want is not None and self._routable():
                    # Healthy replicas exist — on OTHER weights. Failing
                    # here is the version-pinning contract: the client
                    # keeps the bytes it has; a cross-version splice
                    # would silently corrupt the transcript. The
                    # explicit error names the contract (chained on the
                    # root cause) so operators see "rollout pinning",
                    # not a bare replica error.
                    raise EngineUnavailable(
                        f"no replica serves weights {want} for this "
                        f"established stream (rollout in progress)"
                    ) from last_err
                if self.swap_hint > 0:
                    # A rollout swap is mid-flight on the only capacity
                    # (FLEET_SIZE=1 in-place swap): shed with a priced
                    # Retry-After so the LB re-offers after the warmup.
                    raise EngineOverloaded(
                        "no replica available while a weight swap is "
                        "in flight", retry_after=self.swap_hint)
                raise last_err or EngineUnavailable(
                    "no healthy replica available")
            if not established:
                # Fresh (re-)dispatch: (re-)pin to the replica actually
                # serving it — a failed fresh attempt on v1 may replay
                # from scratch on v2 as a fresh request.
                pinned = rep.weights_version() or None
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GenerationTimeout("generation timeout")
            # Between attempts the flight is registered in NO replica's
            # flights set, so a set migrate event here is necessarily a
            # stale nudge from the attempt that just ended (the monitor's
            # eject races the engine error when a replica dies) — clear
            # it, or the fresh dispatch would abort as a spurious second
            # migration and double-spend the budget.
            flight.migrate.clear()
            outcome = payload = None
            async for item in self._attempt_events(
                    rep, flight,
                    prompt=prompt, max_tokens=max_tokens,
                    temperature=temperature, timeout=remaining, seed=seed,
                    resume_ids=(list(export_ids) if migrations else None),
                    delivered=delivered,
                    version=rep.weights_version() or None):
                kind = item[0]
                if kind == "token":
                    delivered += item[1]
                    yield ("token", item[1])
                else:
                    outcome, payload = kind, item[1:]
            if outcome is None:  # pragma: no cover - defensive
                outcome, payload = "err", (
                    EngineUnavailable("attempt ended without an outcome"),
                    [], None)
            if outcome == "done":
                result = payload[0]
                rep.breaker.record_success()
                self._finish_times.append(time.monotonic())
                if self.affinity is not None:
                    # The replica now holds KV for prompt + completion —
                    # the next agent turn extends exactly this prefix.
                    self.affinity.record(prompt + result.text, rep.idx)
                yield ("done", result)
                return
            if outcome == "migrate":
                # Voluntary (drain/eject nudge): no breaker failure.
                err, ids, ver = payload
                if len(ids) > len(export_ids):
                    export_ids = ids
                if export_ids and ver:
                    # The engine's own export stamp is authoritative
                    # for which weights generated the carried ids.
                    pinned = ver
                migrations = self._count_migration(
                    rep, export_ids, migrations, err)
                if trace is not None:
                    trace.event(
                        f"fleet: migrating off replica {rep.idx} "
                        f"({len(export_ids)} tokens carried, drain/eject)")
                    # Span link: the stitched timeline's replica handoff
                    # — the destination's admit events follow it.
                    trace.link("migrated", from_replica=rep.idx,
                               tokens=len(export_ids), cause="drain_eject",
                               weights_version=pinned or "")
                # Don't exclude by index: the nudged replica is already
                # unroutable by STATE (draining/ejected), and the nudge
                # may have hit a hedge branch — excluding the primary
                # here would blacklist the healthy replica serving us.
                exclude = []
                last_err = err
                continue
            # outcome == "err"
            err, ids, ver = payload
            if len(ids) > len(export_ids):
                export_ids = ids
            if export_ids and ver:
                pinned = ver
            if isinstance(err, EngineOverloaded):
                # Backpressure on ONE replica is a routing signal, not an
                # engine failure: try the others once each.
                overload_tried.append(rep.idx)
                last_err = err
                if trace is not None:
                    trace.event(f"fleet: replica {rep.idx} shed "
                                f"(overloaded); rerouting")
                continue
            if not self._is_migratable(err):
                raise err
            rep.last_error = f"{type(err).__name__}: {err}"
            rep.breaker.record_failure()
            migrations = self._count_migration(
                rep, export_ids, migrations, err)
            if trace is not None:
                trace.event(
                    f"fleet: replica {rep.idx} failed mid-request "
                    f"({type(err).__name__}); migrating with "
                    f"{len(export_ids)} generated tokens")
                trace.link("migrated", from_replica=rep.idx,
                           tokens=len(export_ids),
                           cause=type(err).__name__,
                           weights_version=pinned or "")
            logger.warning(
                "fleet: migrating request off replica %d after %s "
                "(%d generated tokens carried)", rep.idx,
                type(err).__name__, len(export_ids))
            exclude = [rep.idx]
            last_err = err

    def _count_migration(self, rep: _Replica, export_ids: List[int],
                         migrations: int,
                         err: Optional[BaseException]) -> int:
        """Shared bookkeeping for BOTH migration arms (voluntary
        drain/eject nudge and engine failure): the budget check comes
        FIRST — a budget-exceeded attempt is not a migration — then the
        fleet/replica counters."""
        migrations += 1
        if migrations > self.migration_budget:
            raise err or EngineUnavailable(
                "fleet migration budget exhausted")
        rep.migrations_out += 1
        self._migrations += 1
        self._migrated_tokens += len(export_ids)
        return migrations

    async def _attempt_events(self, rep: _Replica, flight: _Flight, *,
                              prompt: str, max_tokens: int,
                              temperature: float,
                              timeout: Optional[float], seed: int,
                              resume_ids: Optional[List[int]],
                              delivered: str,
                              version: Optional[str] = None):
        """One (possibly hedged) dispatch, yielded incrementally:

        - ``("token", piece)`` — continuation text past the
          already-delivered prefix (suppression applied here), streamed
          live as the winning branch produces it;
        - terminally ONE of ``("done", result)``, ``("migrate", err,
          ids)`` (drain/eject nudge), or ``("err", err, ids)`` — ``ids``
          is the best export snapshot for the caller's re-splice.
        """
        q: asyncio.Queue = asyncio.Queue()
        branches: List[dict] = []
        mig_task: Optional[asyncio.Task] = None
        pending_skip = len(delivered)
        hedge_armed = self.hedge_ms > 0

        def launch(target: _Replica) -> None:
            tag = len(branches)
            export = RequestExport(ids=list(resume_ids or []))
            target.inflight += 1
            target.dispatches += 1
            target.flights.add(flight)
            task = asyncio.create_task(self._pump(
                tag, target, q,
                prompt=prompt, max_tokens=max_tokens,
                temperature=temperature, timeout=timeout, seed=seed,
                resume_ids=resume_ids, export=export))
            branches.append({"rep": target, "export": export,
                             "task": task, "dead": False})

        async def close_branch(b: dict) -> None:
            if not b["task"].done():
                b["task"].cancel()
                try:
                    await b["task"]
                except (asyncio.CancelledError, Exception):
                    pass
            if not b.get("closed"):
                b["closed"] = True
                b["rep"].inflight -= 1
                b["rep"].flights.discard(flight)

        def best_ids() -> List[int]:
            return list(max((b["export"].ids for b in branches), key=len))

        def best_version() -> Optional[str]:
            """The ENGINE's own stamp of which weights generated the
            best export's ids (set at submit) — what the caller's
            version pin routes on. None for base-protocol engines that
            never see the export."""
            e = max((b["export"] for b in branches),
                    key=lambda ex: len(ex.ids))
            return e.weights_version or None

        def bill_loser(b: dict, cause: str) -> None:
            """Flight recorder + goodput ledger for a losing hedge
            branch. The BILLING itself happens engine-side: the
            export's ``discard`` flag (set before the cancel) makes the
            loser replica's finish path classify its emitted tokens as
            hedge_loser instead of delivered — the engine knows the
            request's tenant and would otherwise bill the same steps as
            goodput the client never received. The fleet only bills its
            own ledger for engines with no ledger at all, and leaves
            the span link (with the cancel cause) so the loser no
            longer vanishes from /debug/requests."""
            if b.get("loser_billed"):
                return
            b["loser_billed"] = True
            lost = len(b["export"].ids) - len(resume_ids or [])
            if lost > 0 and getattr(b["rep"].engine, "ledger",
                                    None) is None:
                self.ledger.record(CLASS_HEDGE_LOSER, lost,
                                   lane=flight.lane)
            trace = current_trace()
            if trace is not None:
                trace.link("hedge_loser", replica=b["rep"].idx,
                           tokens=max(0, lost), cause=cause)

        launch(rep)
        winner: Optional[int] = None
        try:
            if flight.migrate.is_set():
                yield ("migrate", None, list(resume_ids or []), None)
                return
            mig_task = asyncio.create_task(self._migrate_sentinel(flight, q))
            while True:
                try:
                    if hedge_armed and winner is None:
                        item = await asyncio.wait_for(
                            q.get(), self.hedge_ms / 1000.0)
                    else:
                        item = await q.get()
                except asyncio.TimeoutError:
                    # Hedge budget blown with no event yet: dispatch the
                    # same request (same seed/resume — identical bytes)
                    # to a second replica and race the branches.
                    hedge_armed = False
                    # Same-version only: the hedge's whole
                    # contract is that both branches produce identical
                    # bytes, which only holds on identical weights.
                    alt = self._route(
                        prompt, exclude=[b["rep"].idx for b in branches],
                        lane=flight.lane, version=version)
                    if alt is not None:
                        self._hedges += 1
                        trace = current_trace()
                        if trace is not None:
                            trace.event(
                                f"fleet: hedging onto replica {alt.idx} "
                                f"(no event within {self.hedge_ms:.0f}ms "
                                f"from replica {rep.idx})")
                            trace.link("hedge", primary=rep.idx,
                                       hedge=alt.idx)
                        launch(alt)
                    continue
                tag, kind, val = item
                if kind == "migrate":
                    yield ("migrate", None, best_ids(), best_version())
                    return
                b = branches[tag]
                if winner is None and kind == "ev":
                    winner = tag
                    if tag != 0:
                        self._hedge_wins += 1
                    for j, other in enumerate(branches):
                        if j != tag:
                            # Flag BEFORE the cancel: the loser engine's
                            # abort-finish must see it and bill these
                            # tokens as hedge_loser, not delivered.
                            other["export"].discard = True
                            await close_branch(other)
                            bill_loser(other, "lost_race")
                if winner is not None and tag != winner:
                    continue
                if kind == "ev":
                    event, payload = val
                    if event == "token":
                        piece = payload
                        if pending_skip:
                            cut = min(pending_skip, len(piece))
                            pending_skip -= cut
                            piece = piece[cut:]
                        if piece:
                            yield ("token", piece)
                    elif event == "done":
                        yield ("done", payload)
                        return
                elif kind == "end":
                    # Stream closed without a done event — an engine
                    # contract breach; treat as a replica failure, but
                    # (like the err arm) let a still-live hedge branch
                    # win instead of failing the whole attempt.
                    b["dead"] = True
                    if winner is None and any(
                            not ob["dead"] for ob in branches):
                        continue
                    yield ("err", EngineUnavailable(
                        "replica stream ended without a result"),
                        best_ids(), best_version())
                    return
                else:  # kind == "err"
                    b["dead"] = True
                    if winner is None and any(
                            not ob["dead"] for ob in branches):
                        # The primary died before any event but a hedge
                        # is still running — let it win.
                        continue
                    yield ("err", val, best_ids(), best_version())
                    return
        finally:
            if mig_task is not None:
                mig_task.cancel()
                try:
                    await mig_task
                except (asyncio.CancelledError, Exception):
                    pass
            for j, b in enumerate(branches):
                # A branch raced past the winner decision (or the caller
                # tore the attempt down mid-race): still a loser.
                if winner is not None and j != winner:
                    b["export"].discard = True
                await close_branch(b)
                if winner is not None and j != winner:
                    bill_loser(b, "cancelled")

    @staticmethod
    async def _migrate_sentinel(flight: _Flight, q: asyncio.Queue) -> None:
        await flight.migrate.wait()
        q.put_nowait((-1, "migrate", None))

    # ------------------------------------------------------------- serving

    async def generate(self, prompt: str, *, max_tokens: int = 128,
                       temperature: float = 0.0,
                       timeout: Optional[float] = None,
                       seed: Optional[int] = None) -> EngineResult:
        result: Optional[EngineResult] = None
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            if event == "done":
                result = payload
        if result is None:  # pragma: no cover - defensive
            raise EngineUnavailable("fleet stream ended without a result")
        return result

    async def generate_stream(self, prompt: str, *, max_tokens: int = 128,
                              temperature: float = 0.0,
                              timeout: Optional[float] = None,
                              seed: Optional[int] = None
                              ) -> AsyncIterator[str]:
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            if event == "token":
                yield payload

    # ------------------------------------------------------ observability

    async def profile(self, seconds: float, trace_dir: str) -> None:
        """One ``torch.profiler`` capture (``/debug/profile``) on the
        first routable replica's scheduler thread: a process runs one
        profiler session at a time, so one replica is traced. Raises
        when no replica can take it."""
        for rep in self._routable():
            fn = getattr(rep.engine, "profile", None)
            if callable(fn):
                await fn(seconds, trace_dir)
                return
        raise EngineUnavailable("no routable replica to profile")

    def retry_after_hint(self, extra_depth: int = 0) -> float:
        """Retry-After priced from the FLEET-wide drain rate: total
        queued work across replicas over the fleet's recent completion
        rate — a shed must not quote one engine's estimate when N
        replicas are draining the backlog."""
        depth = extra_depth
        for rep in self.replicas:
            q = getattr(rep.engine, "_admissions", None)
            if q is not None:
                depth += q.qsize()
            else:
                depth += len(getattr(rep.engine, "_queue", ()))
        horizon = time.monotonic() - self.DRAIN_RATE_HORIZON_SECS
        ts = [t for t in list(self._finish_times) if t >= horizon]
        if len(ts) >= 2 and ts[-1] > ts[0]:
            rate = (len(ts) - 1) / (ts[-1] - ts[0])
            if rate > 0:
                return min(max(depth / rate, 1.0), 60.0)
        return 5.0

    def qos_health(self) -> dict:
        """Fleet rollup of the replicas' cheap QoS views (/health
        section): lane depths sum, brownout reports the worst replica,
        preemption/expiry counters sum."""
        agg: dict = {"lanes": {}, "brownout_level": 0,
                     "preemptions_total": 0, "preemptions_last_60s": 0,
                     "queue_expired_total": 0, "queue_displaced_total": 0}
        seen = False
        for rep in self.replicas:
            fn = getattr(rep.engine, "qos_health", None)
            if not callable(fn):
                continue
            try:
                q = fn() or {}
            except Exception:   # pragma: no cover - stopped replica
                continue
            seen = True
            for lane, n in (q.get("lanes") or {}).items():
                agg["lanes"][lane] = agg["lanes"].get(lane, 0) + n
            agg["brownout_level"] = max(agg["brownout_level"],
                                        q.get("brownout_level", 0))
            for k in ("preemptions_total", "preemptions_last_60s",
                      "queue_expired_total", "queue_displaced_total"):
                agg[k] += q.get(k, 0)
        return agg if seen else {}

    def kv_pool_health(self) -> dict:
        """Fleet rollup of the replicas' KV-pool views:
        block-state counts and sharing/COW/radix counters sum — each
        replica owns its own pool (block ids are engine-local), so the
        rollup is capacity accounting, not a shared address space."""
        agg: dict = {}
        radix: dict = {}
        host: dict = {}
        host_fails: dict = {}
        seen = radix_seen = host_seen = False
        for rep in self.replicas:
            fn = getattr(rep.engine, "kv_pool_health", None)
            if not callable(fn):
                continue
            try:
                p = fn() or None
            except Exception:   # pragma: no cover - stopped replica
                continue
            if not p:
                continue
            seen = True
            for k, v in p.items():
                if k == "radix":
                    if v:
                        radix_seen = True
                        for rk, rv in v.items():
                            # Budgets/counts sum; per-replica-identical
                            # config passes through below.
                            radix[rk] = radix.get(rk, 0) + rv
                elif k == "host_tier":
                    if v:
                        host_seen = True
                        for hk, hv in v.items():
                            if hk == "onload_fail_total":
                                for cause, n in (hv or {}).items():
                                    host_fails[cause] = (
                                        host_fails.get(cause, 0) + n)
                            else:
                                # capacity/used/free sum like the device
                                # tier's block counts: each replica owns
                                # its own host store, so the rollup is
                                # fleet-wide capacity accounting.
                                host[hk] = host.get(hk, 0) + hv
                elif k == "page":
                    # Config, identical per replica — pass through, a
                    # sum would triple the "tokens per block" math any
                    # consumer derives from the rollup.
                    agg[k] = v
                elif isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
        if not seen:
            return {}
        agg["radix"] = radix if radix_seen else None
        if host_seen:
            host["onload_fail_total"] = host_fails
            agg["host_tier"] = host
        return agg

    def sharding_health(self) -> dict:
        """Fleet view of the replicas' sharding config:
        replicas run one config, so the mesh/fraction/pool fields pass
        through from the first reporting replica; the loud-fallback
        flag is OR-ed — ANY replica silently serving the dense ladder
        under a requested pool must surface at the fleet level."""
        agg: dict = {}
        fallback = False
        draft_fallback = False
        for rep in self.replicas:
            fn = getattr(rep.engine, "sharding_health", None)
            if not callable(fn):
                continue
            try:
                s = fn() or None
            except Exception:   # pragma: no cover - stopped replica
                continue
            if not s:
                continue
            fallback = fallback or bool(s.get("kv_pool_mesh_fallback"))
            draft_fallback = (draft_fallback
                              or bool(s.get("draft_kv_fallback")))
            if not agg:
                agg = dict(s)
        if not agg:
            return {}
        agg["kv_pool_mesh_fallback"] = fallback
        # ANY replica serving the draft KV replicated (the
        # gather fallback) must surface at the fleet level, same rule
        # as the pool's loud fallback.
        agg["draft_kv_fallback"] = draft_fallback
        return agg

    def grammar_health(self) -> dict:
        """Fleet rollup of the replicas' grammar views:
        forced/masked/dead-end totals sum; the compiled-grammar
        identity (hash, profile, state/class counts) passes through —
        replicas run the same config, so their grammars are identical
        by construction."""
        agg: dict = {}
        dead: dict = {}
        seen = False
        for rep in self.replicas:
            fn = getattr(rep.engine, "grammar_health", None)
            if not callable(fn):
                continue
            try:
                g = fn() or None
            except Exception:   # pragma: no cover - stopped replica
                continue
            if not g:
                continue
            seen = True
            for k, v in g.items():
                if k == "dead_ends_total":
                    for ck, cv in (v or {}).items():
                        dead[ck] = dead.get(ck, 0) + cv
                elif k.endswith("_total") and isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
                else:
                    agg[k] = v
        if not seen:
            return {}
        agg["dead_ends_total"] = dead
        return agg

    def spec_health(self) -> dict:
        """Fleet rollup of the replicas' speculative-decode views:
        drafted/accepted/degraded totals sum, the
        acceptance ratio re-derives from the summed totals (ratios
        don't average), identity fields (draft model, k) pass through
        — replicas run one config — and ``active`` is AND-ed (one
        replica's dead draft shows as a fleet-level degradation)."""
        agg: dict = {}
        seen = False
        active = True
        draft_fallback = False
        for rep in self.replicas:
            fn = getattr(rep.engine, "spec_health", None)
            if not callable(fn):
                continue
            try:
                s = fn() or None
            except Exception:   # pragma: no cover - stopped replica
                continue
            if not s:
                continue
            seen = True
            active = active and bool(s.get("active"))
            draft_fallback = (draft_fallback
                              or bool(s.get("draft_kv_fallback")))
            for k, v in s.items():
                if k.endswith("_total") and isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
                elif k not in ("active", "acceptance_ratio",
                               "draft_kv_fallback"):
                    agg[k] = v
        if not seen:
            return {}
        agg["active"] = active
        agg["draft_kv_fallback"] = draft_fallback
        drafted = agg.get("drafted_tokens_total", 0)
        agg["acceptance_ratio"] = (
            round(agg.get("accepted_tokens_total", 0) / drafted, 4)
            if drafted else None)
        return agg

    def steptime_health(self) -> dict:
        """Fleet rollup of the replicas' step-time sentinel snapshots:
        per-key digests merge worst-replica percentiles,
        breaches union WITH replica attribution — a straggling replica
        is exactly a breach naming its index while its siblings' stay
        clean (obs/steptime.py merge_snapshots)."""
        snaps: List[Optional[dict]] = []
        seen = False
        for rep in self.replicas:
            fn = getattr(rep.engine, "steptime_health", None)
            s = None
            if callable(fn):
                try:
                    s = fn() or None
                except Exception:   # pragma: no cover - stopped replica
                    s = None
            seen = seen or bool(s)
            snaps.append(s)
        if not seen:
            return {}
        return obs_steptime.merge_snapshots(snaps)

    def slo_health(self) -> dict:
        """Fleet rollup of the replicas' SLO burn snapshots: per-window
        counts sum, burn rates recompute from the sums (rates don't
        average) — obs/slo.py merge_snapshots."""
        snaps = []
        for rep in self.replicas:
            fn = getattr(rep.engine, "slo_health", None)
            if not callable(fn):
                continue
            try:
                snaps.append(fn() or {})
            except Exception:   # pragma: no cover - stopped replica
                continue
        return obs_slo.merge_snapshots(snaps)

    def ledger_snapshot(self) -> dict:
        """Fleet goodput ledger for /debug/ledger: replica lane tables
        merged with the relay's own hedge-loser ledger, hashed-tenant
        tables summed, conservation re-checked on the merged books."""
        snaps, tenants, conserv = [], {}, []
        for rep in self.replicas:
            fn = getattr(rep.engine, "ledger_snapshot", None)
            if not callable(fn):
                continue
            try:
                s = fn() or {}
            except Exception:   # pragma: no cover - stopped replica
                continue
            for t, row in (s.pop("tenants", None) or {}).items():
                dst = tenants.setdefault(
                    t, {cls: 0 for cls in obs_ledger.LEDGER_CLASSES})
                for cls in obs_ledger.LEDGER_CLASSES:
                    dst[cls] += int(row.get(cls, 0))
            c = s.pop("conservation", None)
            if c:
                conserv.append(c)
            snaps.append(s)
        own = self.ledger.snapshot()
        for t, row in self.ledger.tenant_snapshot().items():
            dst = tenants.setdefault(
                t, {cls: 0 for cls in obs_ledger.LEDGER_CLASSES})
            for cls in obs_ledger.LEDGER_CLASSES:
                dst[cls] += int(row.get(cls, 0))
        conserv.append(self.ledger.conservation())
        snaps.append(own)
        merged = obs_ledger.merge_snapshots(snaps)
        merged["tenants"] = {
            t: obs_ledger.GoodputLedger._derive(row)
            for t, row in sorted(tenants.items())}
        total = sum(c.get("total_steps", 0) for c in conserv)
        accounted = sum(c.get("accounted", 0) for c in conserv)
        merged["conservation"] = {
            "total_steps": total,
            "accounted": accounted,
            "balanced": (accounted == total
                         and all(c.get("balanced") for c in conserv)),
        }
        return merged

    def fleet_health(self) -> dict:
        """Cheap per-replica health view for /health (never calls
        stats() — that drains metric samples owed to the scrape)."""
        reps = []
        last_wall = None
        last_cause = None
        for rep in self.replicas:
            sup = getattr(rep.engine, "supervisor", None)
            reset_iso = cause = None
            if sup is not None and sup.last_reset_wall:
                reset_iso = time.strftime(
                    "%Y-%m-%dT%H:%M:%S",
                    time.gmtime(sup.last_reset_wall)) + "Z"
                cause = sup.last_reset_cause
                if last_wall is None or sup.last_reset_wall > last_wall:
                    last_wall, last_cause = sup.last_reset_wall, cause
            reps.append({
                "replica": rep.idx,
                "state": rep.state,
                "engine_ready": bool(getattr(rep.engine, "ready", False)),
                "breaker": rep.breaker.state,
                "occupancy": rep.occupancy(),
                "inflight": rep.inflight,
                "dispatches": rep.dispatches,
                "migrations_out": rep.migrations_out,
                "weights_version": rep.weights_version() or None,
                "eject_cause": rep.eject_cause,
                "last_error": rep.last_error or None,
                "last_reset": reset_iso,
                "last_reset_cause": cause,
            })
        counts = {s: 0 for s in REPLICA_STATES}
        versions: Dict[str, int] = {}
        for rep in self.replicas:
            counts[rep.state] += 1
            v = rep.weights_version()
            if v:
                versions[v] = versions.get(v, 0) + 1
        return {
            "size": len(self.replicas),
            # Weight rollout: which checkpoint each replica
            # serves — the version table /health and probe_serving
            # print, and the rollout_replicas{version} gauge source.
            "weights_version": self.weights_version or None,
            "versions": versions,
            "canary": ({"replica": self._canary_idx,
                        "share": self._canary_share}
                       if self._canary_idx is not None else None),
            "active": counts[REPLICA_ACTIVE],
            "draining": counts[REPLICA_DRAINING],
            "ejected": counts[REPLICA_EJECTED],
            "migrations": self._migrations,
            "migrated_tokens": self._migrated_tokens,
            "hedges": self._hedges,
            "hedge_wins": self._hedge_wins,
            "drains": self._drains,
            "ejects": self._ejects,
            "rejoins": self._rejoins,
            "last_reset": (time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(last_wall)) + "Z"
                if last_wall else None),
            "last_reset_cause": last_cause,
            "replicas": reps,
        }

    #: stats() keys summed across replicas (everything else is either a
    #: config echo taken from the first reporting replica or fleet-local).
    _SUM_KEYS = ("batch_occupancy", "queue_depth", "kv_pages_used",
                 "kv_pages_total", "queue_rejections", "wasted_decode_steps",
                 "chunks_dispatched", "chunks_consumed", "chunks_pruned",
                 "pipe_inflight", "device_active_slots",
                 "tokens_per_sec_window", "fetches")

    def stats(self) -> dict:
        """Fleet-wide aggregation of the replica schedulers' stats, plus
        the ``fleet`` section the /metrics scrape mirrors into the
        per-replica gauges and migration/hedge counters."""
        agg: dict = {k: 0 for k in self._SUM_KEYS}
        fetch_samples: List[float] = []
        containment: dict = {"resets": {}, "quarantined": {},
                             "health_trips": 0, "replayed_tokens": 0,
                             "replayed_requests": 0, "parked": 0}
        per_replica = []
        replica_stats = []
        for rep in self.replicas:
            fn = getattr(rep.engine, "stats", None)
            s = {}
            if callable(fn):
                try:
                    s = fn() or {}
                except Exception:  # pragma: no cover - stopped replica
                    s = {}
            replica_stats.append(s)
            for k in self._SUM_KEYS:
                v = s.get(k)
                if isinstance(v, (int, float)):
                    agg[k] += v
            for k in ("pipe_depth", "max_queue_depth"):
                if k in s:
                    agg[k] = max(agg.get(k, 0), s[k])
            if "device_termination" in s:
                agg["device_termination"] = s["device_termination"]
            fetch_samples.extend(s.get("chunk_fetch_secs", ()))
            c = s.get("containment") or {}
            for cause, n in c.get("resets", {}).items():
                containment["resets"][cause] = (
                    containment["resets"].get(cause, 0) + n)
            for reason, n in c.get("quarantined", {}).items():
                containment["quarantined"][reason] = (
                    containment["quarantined"].get(reason, 0) + n)
            for k in ("health_trips", "replayed_tokens",
                      "replayed_requests", "parked"):
                containment[k] += c.get(k, 0)
            per_replica.append({
                "replica": rep.idx,
                "state": rep.state,
                "breaker": rep.breaker.state,
                "inflight": rep.inflight,
                "occupancy": s.get("batch_occupancy", rep.occupancy()),
                "queue_depth": s.get("queue_depth", 0),
                "migrations_out": rep.migrations_out,
                "weights_version": rep.weights_version() or None,
            })
        agg["chunk_fetch_secs"] = fetch_samples
        agg["containment"] = containment
        # QoS aggregation: depths/occupancy/counters sum; brownout is
        # the worst replica's level (the fleet is as browned-out as its
        # most-pressured member).
        qos: dict = {"lane_depth": {}, "lane_occupancy": {},
                     "expired": 0, "displaced": 0, "preemptions": 0,
                     "preempted_tokens": 0, "brownout_level": 0,
                     "tenants": 0}
        have_qos = False
        for s in replica_stats:
            q = s.get("qos")
            if not q:
                continue
            have_qos = True
            for key in ("lane_depth", "lane_occupancy"):
                for lane, n in (q.get(key) or {}).items():
                    qos[key][lane] = qos[key].get(lane, 0) + n
            for key in ("expired", "displaced", "preemptions",
                        "preempted_tokens", "tenants"):
                qos[key] += q.get(key, 0)
            qos["brownout_level"] = max(qos["brownout_level"],
                                        q.get("brownout_level", 0))
        if have_qos:
            agg["qos"] = qos
        # Telemetry plane: lane-table ledgers merge (replicas
        # + the relay's hedge-loser ledger); SLO burn windows merge by
        # summed counts.
        led = [s["ledger"] for s in replica_stats if s.get("ledger")]
        if led:
            agg["ledger"] = obs_ledger.merge_snapshots(
                led + [self.ledger.snapshot()])
        slo = [s["slo"] for s in replica_stats if s.get("slo")]
        if slo:
            agg["slo"] = obs_slo.merge_snapshots(slo)
        # KV pool: block-state counts + sharing/radix
        # counters sum across replicas (each owns its own pool).
        if any(s.get("kv_pool") for s in replica_stats):
            agg["kv_pool"] = self.kv_pool_health() or None
        # Grammar: forced/masked/dead-end totals sum; the
        # compiled identity passes through (replicas share one config).
        if any(s.get("grammar") for s in replica_stats):
            agg["grammar"] = self.grammar_health() or None
        # Speculative decoding: drafted/accepted totals sum,
        # acceptance re-derived from the sums.
        if any(s.get("spec") for s in replica_stats):
            agg["spec"] = self.spec_health() or None
        # Sharding: one config fleet-wide — pass-through
        # with the kv_pool_mesh_fallback flag OR-ed across replicas.
        if any(s.get("sharding") for s in replica_stats):
            agg["sharding"] = self.sharding_health() or None
        # Step-time sentinel: per-replica digests merged
        # with replica attribution on breaches.
        if any(s.get("steptime") for s in replica_stats):
            agg["steptime"] = self.steptime_health() or None
        fleet = self.fleet_health()
        fleet["replicas"] = per_replica
        agg["fleet"] = fleet
        return agg
