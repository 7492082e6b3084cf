"""Blast-radius containment for the continuous batcher (the inner ring).

A copy of the JAX package's ``engine/containment.py``. The outer ring —
bounded admission, the circuit breaker, the degraded fallback — keeps a
broken engine from taking down the service. This module is the inner
ring: it keeps a broken request (or one flaky device step) from taking
down the engine. Continuous batching seats many unrelated requests in
one decode step, so without it one poisoned request fails every
cohabitant, and a long-decode victim loses every token it generated.

Three mechanisms, policy here and mechanism in ``BatchedTorchEngine``:

1. **Detection** — the packed chunk (``protocol.pack_chunk``) carries a
   per-slot health word written on the device (NaN/Inf logits, an
   out-of-range sampled token id), and the scheduler's step ``except``
   marks the step poisoned instead of failing every slot.
2. **Quarantine** — culprit isolation: a health bit names its slot; a
   step-wide fault bisects (replay half the suspects, park the rest)
   until the culprit runs alone. A confirmed culprit fails with a
   terminal ``RequestQuarantined`` (HTTP 410) once its per-request
   ``QUARANTINE_RETRY_BUDGET`` is spent — never an endless replay.
3. **Reset-and-replay** — the decode state (KV pool or cache, slot
   vectors, the chunks in flight) is torn down and rebuilt, then every
   surviving request is re-spliced from prompt + generated-so-far ids
   and replayed under its own sampling seed, so a recovered transcript
   equals the fault-free one. Resets are rate-limited
   (``ENGINE_RESET_MAX_PER_MIN``); past the limit the engine fails the
   affected requests fast, whose errors open the breaker, and every
   reset is also reported to the breaker through ``on_reset``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: reset cause labels (the ``engine_resets_total{cause}`` label set,
#: fixed here so the metric's cardinality is bounded by construction).
CAUSE_SLOT_HEALTH = "slot_health"          # device health word tripped
CAUSE_SCHEDULER_ERROR = "scheduler_error"  # exception in a scheduler step
CAUSE_SCHEDULER_DEATH = "scheduler_death"  # scheduler thread died

#: quarantine reason labels (``quarantined_requests_total{reason}``).
REASON_HEALTH = "slot_health"      # repeatedly tripped the health word
REASON_ISOLATED = "step_poison"    # bisection isolated it as the poisoner

#: Early exoneration for bisection probation: once the probe group has
#: consumed this many chunks clean, the parked half is unparked and
#: admissions resume without waiting for the probe to drain — otherwise
#: one transient step-wide fault under long generations would stall
#: every admission for the probe's whole remaining decode. The cost: an
#: intermittent fault that trips again after re-mixing restarts
#: bisection from the full suspect set — extra resets (still budgeted by
#: ENGINE_RESET_MAX_PER_MIN), never a wrong quarantine (terminal blame
#: needs solo implication or a health-named slot, under the retry
#: budget).
PROBATION_CLEAN_CHUNKS = 2


class EngineSupervisor:
    """Reset and quarantine bookkeeping and policy for one engine.

    The scheduler calls in from its own thread; every mutation is behind
    one lock so ``stats()`` reads from the metrics scrape are coherent.
    The supervisor owns the policy (budgets, rate limit, counters); the
    mechanism of tearing down device state and re-splicing requests
    stays in the engine, which knows its buffers.
    """

    def __init__(self, *, retry_budget: int = 1,
                 max_resets_per_min: int = 6,
                 timer: Callable[[], float] = time.monotonic):
        #: how many times one request may be solo-implicated (health
        #: bit, or isolated by bisection) and still be replayed; past it
        #: RequestQuarantined. 0 = quarantine on the first trip.
        self.retry_budget = max(0, retry_budget)
        #: engine resets allowed per rolling minute; 0 = unlimited. Past
        #: the limit the engine must not reset again: it fails the
        #: affected requests instead (the outer ring's food).
        self.max_resets_per_min = max(0, max_resets_per_min)
        self._timer = timer
        self._lock = threading.Lock()
        self._reset_times: deque = deque()
        self.resets: Dict[str, int] = {}
        self.quarantined: Dict[str, int] = {}
        self.health_trips = 0
        self.replayed_tokens = 0
        self.replayed_requests = 0
        self.last_reset_wall: Optional[float] = None   # time.time()
        self.last_reset_cause: Optional[str] = None
        #: how often allow_reset() said no: the sign that this engine
        #: stopped recovering and degraded to fail-fast.
        self.budget_denials = 0
        self.last_denial_wall: Optional[float] = None
        #: listener called (cause) after each recorded reset: the service
        #: wires it to the circuit breaker, so a reset storm opens it
        #: even while individual requests recover.
        self.on_reset: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------- policy

    def allow_reset(self) -> bool:
        """May the engine reset now? False once the rolling-minute budget
        is spent: the caller must degrade to fail-fast (whose errors feed
        the breaker), not reset in a tight loop."""
        if self.max_resets_per_min <= 0:
            return True
        with self._lock:
            self._prune_locked()
            allowed = len(self._reset_times) < self.max_resets_per_min
            if not allowed:
                self.budget_denials += 1
                self.last_denial_wall = time.time()
            return allowed

    def _prune_locked(self) -> None:
        horizon = self._timer() - 60.0
        while self._reset_times and self._reset_times[0] <= horizon:
            self._reset_times.popleft()

    def implicate(self, req) -> bool:
        """One request was solo-implicated (its health bit tripped, or
        bisection isolated it). Bumps ``req.suspect_count``, which lives
        on the request so it survives resets, parking and re-splices.
        True: the retry budget is spent, the caller quarantines the
        request; False: the caller replays it (a transient device fault
        must not kill an innocent request)."""
        req.suspect_count += 1
        return req.suspect_count > self.retry_budget

    @staticmethod
    def split(suspects: List) -> Tuple[List, List]:
        """A bisection step for a step-wide fault with an unknown
        culprit: (probe, parked). The probe half replays now; the parked
        half waits until the probe drains clean (innocent: unpark) or
        poisons another step (recurse into the probe's survivors)."""
        mid = (len(suspects) + 1) // 2
        return suspects[:mid], suspects[mid:]

    # ---------------------------------------------------------- recording

    def note_reset(self, cause: str) -> None:
        with self._lock:
            self._reset_times.append(self._timer())
            self.resets[cause] = self.resets.get(cause, 0) + 1
            self.last_reset_wall = time.time()
            self.last_reset_cause = cause
        listener = self.on_reset
        if listener is not None:
            try:
                listener(cause)
            except Exception:  # pragma: no cover - the listener is best-effort
                pass

    def note_quarantine(self, reason: str) -> None:
        with self._lock:
            self.quarantined[reason] = self.quarantined.get(reason, 0) + 1

    def note_health_trips(self, n: int = 1) -> None:
        with self._lock:
            self.health_trips += n

    def note_replay(self, tokens: int) -> None:
        with self._lock:
            self.replayed_requests += 1
            self.replayed_tokens += max(0, tokens)

    # ------------------------------------------------------ observability

    def stats(self) -> dict:
        """Cumulative totals for the metrics mirror
        (``server/metrics.py::observe_containment``) and /health."""
        with self._lock:
            return {
                "resets": dict(self.resets),
                "quarantined": dict(self.quarantined),
                "health_trips": self.health_trips,
                "replayed_tokens": self.replayed_tokens,
                "replayed_requests": self.replayed_requests,
                "retry_budget": self.retry_budget,
                "max_resets_per_min": self.max_resets_per_min,
                "last_reset_wall": self.last_reset_wall,
                "last_reset_cause": self.last_reset_cause,
                "budget_denials": self.budget_denials,
            }
