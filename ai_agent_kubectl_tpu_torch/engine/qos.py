"""Deadline-aware QoS ring: tenant/lane classification, fair-share
admission, and the brownout controller (a copy of the JAX package's
``engine/qos.py``; the port imports nothing of that package).

The serving path used to admit through a single FIFO ``queue.Queue`` —
one tenant flooding ``/kubectl-command`` starved every other client, and
an interactive request queued behind a 60-turn ``/execute`` agent loop.
SGLang's lesson (PAPERS.md) is that scheduler *policy*, not kernels, is
what keeps a multi-tenant LLM service live under contention. This module
is that policy layer, engine-agnostic and host-side:

- **Lanes** — every request runs in one of three priority lanes
  (``interactive`` > ``batch`` > ``background``). The lane comes from
  the tenant's configured tier (``TENANT_TIERS``) or an ``X-Priority``
  header, clamped so a client can never claim a higher lane than its
  tier allows.
- **Tenants** — the fair-share unit: the API key when one is presented,
  else the client IP (``classify``). Tenants are queue-internal only —
  they never become metric labels (unbounded cardinality).
- **QoSQueue** — weighted deficit-round-robin over per-tenant sub-queues
  (weights by lane), with per-tenant in-queue caps (429 to the flooding
  tenant, not 503 to everyone), expired-deadline purge at scan time
  (``queue_expired_total`` — an expired request must not occupy
  MAX_QUEUE_DEPTH until popped), and shed decisions that prefer the
  flooding tenant (a quiet tenant arriving at a full queue displaces the
  dominant tenant's newest request instead of being shed itself).
- **BrownoutController** — AIMD trim of effective per-lane concurrency:
  when interactive queue-wait p95 breaches ``SLO_INTERACTIVE_MS``,
  background's slot share halves first (then batch); recovery is
  additive, batch first, background last. The level is metric-visible
  (``qos_brownout_level``). Shares floor at one slot so brownout trims
  but never starves a lane outright.

The engine scheduler (``engine/batcher.py``) owns the *mechanism* —
preemptive decode through its replay path rides there; this module
owns classification and queue policy, the same policy as the JAX
package's, so the two packages never disagree on what "fair" means.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Deque, Dict, List, Optional, Tuple

#: the closed lane set, lowest priority first. Fixed here so lane names
#: can be Prometheus labels with cardinality bounded by construction.
LANE_BACKGROUND = "background"
LANE_BATCH = "batch"
LANE_INTERACTIVE = "interactive"
LANES = (LANE_BACKGROUND, LANE_BATCH, LANE_INTERACTIVE)
LANE_RANK = {lane: i for i, lane in enumerate(LANES)}
#: highest-priority-first iteration order (credit spending, preemption).
LANES_DESC = tuple(reversed(LANES))

#: default WDRR weights — one full round of a saturated queue serves
#: 8 interactive : 4 batch : 1 background.
DEFAULT_LANE_WEIGHTS = {LANE_INTERACTIVE: 8, LANE_BATCH: 4,
                        LANE_BACKGROUND: 1}

#: tenant key when no API key and no client address is known (direct
#: engine calls, tests) — one shared fair-share bucket.
ANON_TENANT = "anon"


def lane_rank(lane: Optional[str]) -> int:
    """Rank of a (possibly unknown) lane name; unknown ranks lowest so a
    corrupt lane string can never outrank real traffic."""
    return LANE_RANK.get(lane or "", -1)


def parse_lane_weights(spec: str) -> Dict[str, int]:
    """``"interactive:8,batch:4,background:1"`` → weight map. Missing
    lanes keep their defaults; a typo'd lane or weight is a startup
    error, not a silently skewed scheduler."""
    weights = dict(DEFAULT_LANE_WEIGHTS)
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        lane, sep, w = item.partition(":")
        lane = lane.strip().lower()
        if not sep or lane not in LANES:
            raise ValueError(
                f"LANE_WEIGHTS entry {item!r} must be lane:weight with "
                f"lane in {LANES}")
        weight = int(w)
        if weight < 1:
            raise ValueError(f"LANE_WEIGHTS weight must be >= 1, got {w}")
        weights[lane] = weight
    return weights


def parse_tenant_tiers(spec: str) -> Dict[str, str]:
    """``"keyA:interactive,10.0.0.5:background"`` → tenant-key → max-lane
    map (the *tier*: the highest lane that tenant may claim)."""
    tiers: Dict[str, str] = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        tenant, sep, lane = item.rpartition(":")
        lane = lane.strip().lower()
        if not sep or not tenant.strip() or lane not in LANES:
            raise ValueError(
                f"TENANT_TIERS entry {item!r} must be tenant:lane with "
                f"lane in {LANES}")
        tiers[tenant.strip()] = lane
    return tiers


@dataclasses.dataclass(frozen=True)
class QoSContext:
    """One request's QoS classification, carried from the HTTP layer to
    the engine scheduler on a contextvar (same pattern as obs.trace —
    it crosses awaits and task spawns, and the engine reads it once at
    submit time)."""

    tenant: str = ANON_TENANT
    lane: str = LANE_INTERACTIVE
    #: client-declared session identity (``X-Session-ID``):
    #: the unit the per-session token budget and the turn-N TTFT SLO
    #: account on. Empty = sessionless request (budget never applies).
    session: str = ""


_qos_var: ContextVar[Optional[QoSContext]] = ContextVar("qos_context",
                                                        default=None)


def current_qos() -> Optional[QoSContext]:
    return _qos_var.get()


@contextmanager
def use_qos(ctx: QoSContext):
    token = _qos_var.set(ctx)
    try:
        yield ctx
    finally:
        _qos_var.reset(token)


def classify(api_key: Optional[str], client_ip: Optional[str],
             priority_header: Optional[str],
             tiers: Dict[str, str],
             default_lane: str = LANE_INTERACTIVE,
             session: Optional[str] = None) -> QoSContext:
    """Tenant + lane for one request.

    Tenant: the API key when presented, else the client IP (the same
    identity the rate limiter buckets on). Lane: the ``X-Priority``
    request when valid, else the tenant's tier default — always clamped
    to the tier, so a client can *lower* its own priority freely (a
    polite bulk importer self-labels ``background``) but can never claim
    a lane above what its tier grants. ``session`` is the raw
    ``X-Session-ID`` header; it is namespaced under the tenant so one
    client can never spend (or observe) another tenant's budget by
    guessing its session string."""
    tenant = (api_key or "").strip() or (client_ip or "").strip() \
        or ANON_TENANT
    tier = tiers.get(tenant, default_lane)
    if tier not in LANES:
        tier = default_lane
    requested = (priority_header or "").strip().lower()
    lane = requested if requested in LANES else tier
    if lane_rank(lane) > lane_rank(tier):
        lane = tier
    sid = (session or "").strip()
    return QoSContext(tenant=tenant, lane=lane,
                      session=f"{tenant}/{sid}" if sid else "")


class SessionBudgets:
    """Per-session completion-token budgets.

    A multi-turn agent session is exactly the workload the two-tier KV
    cache accelerates — which also makes it the workload that can
    monopolize the engine (every turn re-admits radix-warm and wins the
    TTFT race against cold strangers). The budget is the counterweight:
    once a session has been *delivered* ``budget_tokens`` completion
    tokens, its later turns classify into the background lane. The
    session keeps working (lanes never starve outright — WDRR guarantees
    background a share) but stops outranking fresh interactive traffic.

    Accounting is delivered tokens (the billing ledger's unit), charged
    at finish by the engine scheduler — not at admission — so a shed or
    failed turn never burns budget. State is a bounded LRU keyed by the
    namespaced session id (``tenant/session``): at ``max_sessions`` the
    coldest session's counter is dropped, which *resets* that session's
    budget — the benign failure mode (a forgotten session regains
    priority) rather than an unbounded-memory one. ``budget_tokens <= 0``
    disables the whole mechanism. Thread-safe: charge runs on the
    scheduler thread, lane_for on the event loop."""

    def __init__(self, budget_tokens: int, *, max_sessions: int = 2048):
        self.budget_tokens = max(0, int(budget_tokens))
        self.max_sessions = max(1, int(max_sessions))
        self._lock = threading.Lock()
        self._spent: "OrderedDict[str, int]" = OrderedDict()
        self.demoted_total = 0
        self.evicted_total = 0

    @property
    def enabled(self) -> bool:
        return self.budget_tokens > 0

    def charge(self, session: str, tokens: int) -> None:
        """Add delivered completion tokens to a session's tally."""
        if not self.enabled or not session or tokens <= 0:
            return
        with self._lock:
            self._spent[session] = self._spent.get(session, 0) + int(tokens)
            self._spent.move_to_end(session)
            while len(self._spent) > self.max_sessions:
                self._spent.popitem(last=False)
                self.evicted_total += 1

    def over(self, session: str) -> bool:
        if not self.enabled or not session:
            return False
        with self._lock:
            return self._spent.get(session, 0) >= self.budget_tokens

    def lane_for(self, session: str, lane: str) -> str:
        """Clamp an over-budget session to the background lane (counted);
        requests already there pass through unchanged."""
        if lane != LANE_BACKGROUND and self.over(session):
            self.demoted_total += 1
            return LANE_BACKGROUND
        return lane

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            over = sum(1 for v in self._spent.values()
                       if v >= self.budget_tokens) if self.enabled else 0
            return {
                "enabled": self.enabled,
                "budget_tokens": self.budget_tokens,
                "sessions_tracked": len(self._spent),
                "sessions_over_budget": over,
                "demoted_total": self.demoted_total,
                "evicted_total": self.evicted_total,
            }


# TenantOverloaded lives in engine.protocol (it must subclass
# EngineOverloaded so the breaker's overload-passthrough treats it as
# backpressure); re-exported here so
# QoS consumers have one import site.
from .protocol import TenantOverloaded  # noqa: E402


class QoSQueue:
    """Weighted deficit-round-robin admission queue over per-tenant
    sub-queues, grouped by lane.

    Drop-in for the batcher's ``queue.Queue`` surface (``put`` /
    ``get(timeout)`` / ``get_nowait`` / ``qsize`` / ``empty``, raising
    ``queue.Empty``), thread-safe (event-loop put, scheduler-thread
    get). Entries are the engines' request objects; the queue reads
    ``lane`` / ``tenant`` / ``deadline`` / ``cancel`` off them (missing
    attributes default to one interactive anon bucket — the pre-QoS
    behaviour) and stamps ``t_enqueue``.

    Policy in one place:

    - **WDRR**: each scheduling round grants every lane credit equal to
      its weight; pops spend credit highest-lane-first, so a saturated
      queue serves weights-proportionally per round with interactive
      served first within the round, and no lane ever starves.
    - **Per-tenant fairness**: within a lane, tenants round-robin
      (OrderedDict rotation); within a tenant, FIFO.
    - **Per-tenant cap**: a tenant with ``tenant_cap`` requests already
      queued is shed with :class:`TenantOverloaded` (HTTP 429 — the
      flooding tenant's problem, not everyone's).
    - **Flood-preferring displacement**: at global ``max_depth``, an
      arrival from a NON-dominant tenant displaces the dominant
      tenant's newest request at an equal-or-lower lane instead of
      being shed; the displaced requests are returned to the caller to
      error. An arrival from the dominant tenant itself sheds with the
      classic "admission queue full" EngineOverloaded.
    - **Scan-time expiry**: queue scans purge entries whose effective
      deadline passed (preempted-out time excluded via ``preempt_t0``)
      and count them (``expired_total``), calling ``on_expire`` so the
      engine can fail them with GenerationTimeout — an expired request
      stops occupying MAX_QUEUE_DEPTH the moment it is dead, not when
      it reaches the head.
    """

    #: background purge cadence during get() scans; puts at capacity
    #: always purge first (a full queue must shed live work only).
    PURGE_INTERVAL_SECS = 0.05

    def __init__(self, *, max_depth: int = 0, tenant_cap: int = 0,
                 weights: Optional[Dict[str, int]] = None,
                 on_expire: Optional[Callable] = None):
        self.max_depth = max(0, int(max_depth))
        # 0 = no per-tenant cap beyond the global depth.
        self.tenant_cap = max(0, int(tenant_cap))
        self.weights = dict(DEFAULT_LANE_WEIGHTS)
        if weights:
            self.weights.update(weights)
        self.on_expire = on_expire
        self._cond = threading.Condition()
        self._lanes: Dict[str, "OrderedDict[str, Deque]"] = {
            lane: OrderedDict() for lane in LANES}
        self._credit: Dict[str, float] = {lane: 0.0 for lane in LANES}
        self._size = 0
        self._last_purge = 0.0
        self.expired_total = 0
        self.displaced_total = 0

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _lane_of(req) -> str:
        lane = getattr(req, "lane", None)
        return lane if lane in LANES else LANE_INTERACTIVE

    @staticmethod
    def _tenant_of(req) -> str:
        return getattr(req, "tenant", None) or ANON_TENANT

    @staticmethod
    def _effective_deadline(req) -> Optional[float]:
        """Deadline with preempted-out time excluded: a victim parked in
        the queue since ``preempt_t0`` gets that wall time back on
        resume (the engine credits it at admission), so the purge must
        judge it against the same extended deadline."""
        deadline = getattr(req, "deadline", None)
        if deadline is None:
            return None
        t0 = getattr(req, "preempt_t0", None)
        if t0 is not None:
            deadline += time.monotonic() - t0
        return deadline

    def _tenant_count(self, tenant: str) -> int:
        return sum(len(self._lanes[lane].get(tenant, ()))
                   for lane in LANES)

    # ------------------------------------------------------------ purging

    def _purge_locked(self, now: float, force: bool = False) -> None:
        if not force and now - self._last_purge < self.PURGE_INTERVAL_SECS:
            return
        self._last_purge = now
        expired: List = []
        for lane in LANES:
            tenants = self._lanes[lane]
            for tenant in list(tenants):
                dq = tenants[tenant]
                kept: Deque = deque()
                for req in dq:
                    cancel = getattr(req, "cancel", None)
                    if cancel is not None and cancel.is_set():
                        self._size -= 1      # client gone: drop silently
                        continue
                    deadline = self._effective_deadline(req)
                    if deadline is not None and now > deadline:
                        self._size -= 1
                        self.expired_total += 1
                        expired.append(req)
                        continue
                    kept.append(req)
                if kept:
                    tenants[tenant] = kept
                else:
                    del tenants[tenant]
        for req in expired:
            if self.on_expire is not None:
                try:
                    self.on_expire(req)
                except Exception:   # pragma: no cover - callback guard
                    pass

    # ------------------------------------------------------------- put

    def put(self, req) -> List:
        """Enqueue; returns requests displaced to make room (caller must
        fail them with an overload error). Raises
        :class:`TenantOverloaded` at the per-tenant cap and
        ``EngineOverloaded`` when the queue is full and this tenant is
        the one flooding it."""
        from .protocol import EngineOverloaded

        lane, tenant = self._lane_of(req), self._tenant_of(req)
        now = time.monotonic()
        displaced: List = []
        with self._cond:
            if (self.max_depth and self._size >= self.max_depth) or (
                    self.tenant_cap
                    and self._tenant_count(tenant) >= self.tenant_cap):
                # Make room from the dead before shedding the living.
                self._purge_locked(now, force=True)
            mine = self._tenant_count(tenant)
            if self.tenant_cap and mine >= self.tenant_cap:
                raise TenantOverloaded(
                    f"tenant queue cap reached ({mine}/{self.tenant_cap} "
                    f"queued for tenant {tenant!r}, lane {lane})",
                    tenant=tenant, lane=lane)
            if self.max_depth and self._size >= self.max_depth:
                victim = self._displacement_victim_locked(tenant, lane)
                if victim is None:
                    raise EngineOverloaded(
                        f"admission queue full "
                        f"({self._size}/{self.max_depth})")
                displaced.append(victim)
                self.displaced_total += 1
            req.t_enqueue = now
            tenants = self._lanes[lane]
            if tenant not in tenants:
                tenants[tenant] = deque()
            tenants[tenant].append(req)
            self._size += 1
            self._cond.notify()
        return displaced

    def _displacement_victim_locked(self, tenant: str, lane: str):
        """Shed decisions prefer the flooding tenant: the arriving
        request bumps the NEWEST queued request of the tenant holding
        the most queue share — but only when that tenant out-queues the
        arriver and the victim's lane doesn't outrank the arrival (a
        background request never displaces interactive work)."""
        counts: Dict[str, int] = {}
        for lane_q in self._lanes.values():
            for t, dq in lane_q.items():
                counts[t] = counts.get(t, 0) + len(dq)
        mine = counts.get(tenant, 0)
        fat = [(n, t) for t, n in counts.items() if t != tenant and n > mine]
        if not fat:
            return None
        fat.sort(reverse=True)
        arrival_rank = lane_rank(lane)
        for _, victim_tenant in fat:
            for victim_lane in LANES:        # lowest lane first
                if lane_rank(victim_lane) > arrival_rank:
                    break
                dq = self._lanes[victim_lane].get(victim_tenant)
                if not dq:
                    continue
                # Newest first, but NEVER a request that was already
                # admitted once (preempted victim / supervisor requeue,
                # carrying resume state): its client may already hold
                # streamed tokens, and shedding it would break the
                # byte-identical-completion contract.
                for i in range(len(dq) - 1, -1, -1):
                    req = dq[i]
                    if (getattr(req, "preempt_count", 0)
                            or getattr(req, "resume_ids", None)):
                        continue
                    del dq[i]
                    if not dq:
                        del self._lanes[victim_lane][victim_tenant]
                    self._size -= 1
                    return req
        return None

    def requeue_head(self, req) -> None:
        """Front-of-tenant-queue re-entry for preempted victims and
        supervisor requeues: never sheds, never counts against caps —
        the request was already admitted once."""
        lane, tenant = self._lane_of(req), self._tenant_of(req)
        with self._cond:
            req.t_enqueue = time.monotonic()
            tenants = self._lanes[lane]
            if tenant not in tenants:
                tenants[tenant] = deque()
                tenants.move_to_end(tenant, last=False)
            tenants[tenant].appendleft(req)
            self._size += 1
            self._cond.notify()

    # ------------------------------------------------------------- get

    def _pop_tenant_locked(self, lane: str):
        tenants = self._lanes[lane]
        tenant, dq = next(iter(tenants.items()))
        req = dq.popleft()
        if dq:
            tenants.move_to_end(tenant)      # round-robin across tenants
        else:
            del tenants[tenant]
        self._size -= 1
        return req

    def _pop_locked(self, exclude_lanes=(), min_lane: Optional[str] = None):
        self._purge_locked(time.monotonic())
        min_rank = lane_rank(min_lane) if min_lane else -1

        def available():
            return [lane for lane in LANES_DESC
                    if self._lanes[lane] and lane not in exclude_lanes
                    and lane_rank(lane) >= min_rank]

        avail = available()
        if not avail:
            return None
        # WDRR: spend this round's remaining credit highest-lane-first;
        # when every available lane's credit is spent, start a new round
        # (credit := weight). Empty lanes never accumulate credit across
        # rounds, so a lane waking after idling can't burst past its
        # share.
        for lane in avail:
            if self._credit[lane] >= 1.0:
                self._credit[lane] -= 1.0
                return self._pop_tenant_locked(lane)
        for lane in LANES:
            self._credit[lane] = float(self.weights[lane]) \
                if self._lanes[lane] else 0.0
        lane = avail[0]
        self._credit[lane] -= 1.0
        return self._pop_tenant_locked(lane)

    def get(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                req = self._pop_locked()
                if req is not None:
                    return req
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    # Condition timed out (or raced): one last try.
                    req = self._pop_locked()
                    if req is not None:
                        return req
                    raise _queue.Empty()

    def get_nowait(self, exclude_lanes=(), min_lane: Optional[str] = None):
        with self._cond:
            req = self._pop_locked(exclude_lanes, min_lane)
            if req is None:
                raise _queue.Empty()
            return req

    def drain(self) -> List:
        """Pop everything (shutdown paths), fairness-blind."""
        out: List = []
        with self._cond:
            for lane_q in self._lanes.values():
                for dq in lane_q.values():
                    out.extend(dq)
                lane_q.clear()
            self._size = 0
        return out

    # ------------------------------------------------------ observability

    def qsize(self) -> int:
        return self._size

    __len__ = qsize

    def empty(self) -> bool:
        return self._size == 0

    def lane_depths(self) -> Dict[str, int]:
        with self._cond:
            return {lane: sum(len(dq) for dq in self._lanes[lane].values())
                    for lane in LANES}

    def tenant_depths(self) -> Dict[str, int]:
        with self._cond:
            counts: Dict[str, int] = {}
            for lane_q in self._lanes.values():
                for t, dq in lane_q.items():
                    counts[t] = counts.get(t, 0) + len(dq)
            return counts

    def starved_lane(self, now: float, wait_secs: float,
                     exclude=()) -> Optional[str]:
        """Highest lane holding a request enqueued more than
        ``wait_secs`` ago — the preemption trigger. Judged on
        ``t_enqueue`` (stamped by put/requeue), so a just-preempted
        victim can't immediately read as starved itself; the whole
        deque is scanned, not just its head (a requeued victim's fresh
        stamp must not mask an older request queued behind it).
        ``exclude`` names lanes a preemption can't help (brownout-capped
        — a freed slot would be unadmittable for them anyway)."""
        with self._cond:
            for lane in LANES_DESC:
                if lane in exclude:
                    continue
                for dq in self._lanes[lane].values():
                    if any(now - getattr(req, "t_enqueue", now) > wait_secs
                           for req in dq):
                        return lane
        return None

    def stats(self) -> Dict:
        return {
            "lane_depth": self.lane_depths(),
            "expired": self.expired_total,
            "displaced": self.displaced_total,
            "tenants": len(self.tenant_depths()),
        }


class BrownoutController:
    """AIMD trim of effective per-lane decode concurrency.

    Interactive queue-wait samples feed a trailing window; when their
    p95 breaches ``slo_ms``, the controller multiplicatively halves
    background's slot share first, and only once background is at its
    floor does batch start shedding — "background sheds first".
    Recovery is additive and in the opposite order (batch first,
    background last), so a recovering service restores its paying lanes
    before its bulk lanes. ``slo_ms <= 0`` disables the controller
    (level stays 0, shares stay 1.0).

    The *engine scheduler* enforces the shares: lane slot caps are
    ``max(1, int(batch_size * share))`` — a brownout trims a lane's
    concurrency, it never zeroes it (the acceptance bar says no lane is
    ever starved outright).
    """

    #: multiplicative-decrease factor and additive-increase step.
    DECREASE = 0.5
    INCREASE = 0.125
    #: background must reach this floor before batch starts shedding.
    FLOOR = 0.25

    def __init__(self, slo_ms: float, *, window_secs: float = 10.0,
                 eval_interval_secs: float = 1.0):
        self.slo_ms = float(slo_ms)
        self.window_secs = window_secs
        self.eval_interval_secs = eval_interval_secs
        self.shares: Dict[str, float] = {LANE_BACKGROUND: 1.0,
                                         LANE_BATCH: 1.0}
        self._waits: Deque[Tuple[float, float]] = deque(maxlen=4096)
        self._last_eval = 0.0
        self.transitions = 0

    @property
    def level(self) -> int:
        """0 = no brownout, 1 = background trimmed, 2 = batch trimmed
        too (the metric-visible state)."""
        if self.shares[LANE_BATCH] < 1.0:
            return 2
        if self.shares[LANE_BACKGROUND] < 1.0:
            return 1
        return 0

    def note_queue_wait(self, lane: str, wait_ms: float,
                        now: Optional[float] = None) -> None:
        """Feed one admission's queue wait; only interactive waits drive
        the SLO (that's the lane the brownout protects)."""
        if lane != LANE_INTERACTIVE or self.slo_ms <= 0:
            return
        self._waits.append((time.monotonic() if now is None else now,
                            wait_ms))

    def _p95_locked(self, now: float) -> Optional[float]:
        horizon = now - self.window_secs
        while self._waits and self._waits[0][0] < horizon:
            self._waits.popleft()
        vals = sorted(w for _, w in self._waits)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(round(0.95 * (len(vals) - 1))))]

    def maybe_eval(self, now: Optional[float] = None,
                   burn_fn: Optional[Callable[[], Optional[float]]] = None
                   ) -> bool:
        """Time-gated AIMD step; returns True when the shares changed.
        Called from the scheduler loop — cheap when gated out.

        ``burn_fn`` is the SLO burn-rate input (obs/slo.py): evaluated
        only when the time gate passes, a fast-window burn rate > 1.0
        for interactive queue wait counts as a breach even while the
        raw p95 still sits under the threshold — the budget is being
        eaten faster than the objective allows, which is exactly when
        trimming bulk lanes early is cheaper than paging later. None
        (or a burn_fn returning None — no samples) keeps the classic
        p95-only behaviour."""
        if self.slo_ms <= 0:
            return False
        now = time.monotonic() if now is None else now
        if now - self._last_eval < self.eval_interval_secs:
            return False
        self._last_eval = now
        p95 = self._p95_locked(now)
        burn = burn_fn() if burn_fn is not None else None
        before = dict(self.shares)
        if (p95 is not None and p95 > self.slo_ms) or (
                burn is not None and burn > 1.0):
            if self.shares[LANE_BACKGROUND] > self.FLOOR:
                self.shares[LANE_BACKGROUND] = max(
                    self.FLOOR, self.shares[LANE_BACKGROUND] * self.DECREASE)
            else:
                self.shares[LANE_BATCH] = max(
                    self.FLOOR, self.shares[LANE_BATCH] * self.DECREASE)
        elif p95 is None or p95 < 0.8 * self.slo_ms:
            # Recover batch to full before background gets anything back.
            if self.shares[LANE_BATCH] < 1.0:
                self.shares[LANE_BATCH] = min(
                    1.0, self.shares[LANE_BATCH] + self.INCREASE)
            elif self.shares[LANE_BACKGROUND] < 1.0:
                self.shares[LANE_BACKGROUND] = min(
                    1.0, self.shares[LANE_BACKGROUND] + self.INCREASE)
        changed = self.shares != before
        if changed:
            self.transitions += 1
        return changed

    def lane_cap(self, lane: str, batch_size: int) -> int:
        """Effective slot cap for ``lane`` under the current shares.
        Interactive is never trimmed; trimmed lanes floor at one slot."""
        share = self.shares.get(lane)
        if share is None or share >= 1.0:
            return batch_size
        return max(1, int(batch_size * share))
