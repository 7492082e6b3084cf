"""Rolling-window circuit breaker for the engine path.

The reference let every request ride a failing engine to
its full timeout: 60 s of held connection per doomed call. The breaker
watches engine outcomes and, after ``threshold`` failures inside
``window_secs`` (watchdog trips surface as EngineUnavailable and count),
OPENS: requests stop touching the engine and either fail fast or — with
``DEGRADED_FALLBACK=true`` — route to the rule-based FallbackEngine.
After ``recovery_secs`` it goes HALF-OPEN: exactly one probe request is
let through to the real engine; success re-CLOSES the breaker, failure
re-opens it for another ``recovery_secs``.

Single-threaded by design: all transitions happen on the event loop, so
no locks. ``threshold=0`` disables the breaker entirely (it never opens).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Optional

from ..obs.trace import trace_event

CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"

#: Prometheus encoding of the state (server/metrics.py breaker_state).
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        threshold: int = 5,
        window_secs: float = 30.0,
        recovery_secs: float = 15.0,
        timer: Callable[[], float] = time.monotonic,
    ):
        # Follow the sibling knobs' "0 disables" convention rather than
        # crashing the server at startup on BREAKER_WINDOW_SECS=0: a
        # non-positive window means the breaker never opens.
        if window_secs <= 0:
            threshold = 0
            window_secs = 1.0
        self.threshold = threshold
        self.window_secs = window_secs
        self.recovery_secs = max(0.0, recovery_secs)
        self._timer = timer
        self._failures: Deque[float] = deque()
        self._open = False
        self._opened_at = 0.0
        self._probe_inflight = False
        self.opens = 0          # lifetime open transitions (observability)
        # Epoch fencing for long-lived engine calls: llm_timeout (60 s)
        # routinely outlives a closed→open→half-open cycle (recovery 15 s),
        # so a call admitted BEFORE the breaker opened can report its
        # outcome while a half-open probe is in flight. Outcomes carrying
        # a stale epoch are ignored — a pre-outage success must not close
        # an open breaker, and a pre-outage failure must not clobber the
        # probe slot or restart the recovery clock.
        self._epoch = 0

    # ------------------------------------------------------------- state

    @property
    def state(self) -> str:
        if not self._open:
            return CLOSED
        if self._timer() - self._opened_at >= self.recovery_secs:
            return HALF_OPEN
        return OPEN

    def begin(self) -> Optional[int]:
        """Admission check: a call token (the current epoch) when an engine
        call may proceed, None when calls are suspended. In HALF_OPEN only
        one probe is admitted at a time; everyone else keeps the
        fallback/503 path until the probe reports back. Pass the token to
        record_success/record_failure/release_probe so outcomes from
        before the last open transition are fenced off."""
        s = self.state
        if s == CLOSED:
            return self._epoch
        if s == HALF_OPEN and not self._probe_inflight:
            self._probe_inflight = True
            trace_event("breaker: half-open — this call is the probe")
            return self._epoch
        trace_event(f"breaker: {s} — engine call suspended")
        return None

    # No side-effect-free "allow()" helper on purpose: in HALF_OPEN an
    # admission check CONSUMES the single probe slot, so any caller that
    # asked without then reporting an outcome would wedge the breaker.
    # Callers must use begin() and hold the token; pure introspection is
    # the `state` property.

    # ----------------------------------------------------------- outcomes

    def _stale(self, token: Optional[int]) -> bool:
        return token is not None and token != self._epoch

    def release_probe(self, token: Optional[int] = None) -> None:
        """Return an undecided half-open probe slot: the call ended without
        an engine outcome (client cancelled mid-probe, or the submission
        was shed as overload). Without this the breaker would wedge in
        half-open forever — _probe_inflight stuck True, begin() None for
        everyone. No-op outside half-open."""
        if self._stale(token):
            return
        self._probe_inflight = False

    def record_success(self, token: Optional[int] = None) -> None:
        if self._stale(token):
            return
        if self._open:
            # Successful half-open probe: re-close with a clean slate.
            self._failures.clear()
            self._open = False
            self._probe_inflight = False
        # Closed-state successes deliberately do NOT erase the failure
        # window: under partial failure (one bad shard failing 50% of
        # calls) interleaved successes would otherwise reset the count
        # forever and the breaker would never open — it's a rolling
        # window, not a consecutive-failure counter. Old failures age out
        # via window_secs.

    def record_failure(self, token: Optional[int] = None) -> None:
        if self._stale(token):
            return
        now = self._timer()
        if self._open:
            # A failed half-open probe: restart the recovery clock and
            # fence off any other outstanding calls from this cycle.
            self._opened_at = now
            self._probe_inflight = False
            self._epoch += 1
            trace_event("breaker: half-open probe failed — re-opening")
            return
        horizon = now - self.window_secs
        while self._failures and self._failures[0] <= horizon:
            self._failures.popleft()
        self._failures.append(now)
        trace_event(f"breaker: engine failure recorded "
                    f"({len(self._failures)}/{self.threshold} in window)")
        if self.threshold > 0 and len(self._failures) >= self.threshold:
            self._open = True
            self._opened_at = now
            self._probe_inflight = False
            self._epoch += 1
            self.opens += 1
            trace_event("breaker: threshold reached — OPENING")

    # ------------------------------------------------------ observability

    @property
    def recent_failures(self) -> int:
        horizon = self._timer() - self.window_secs
        while self._failures and self._failures[0] <= horizon:
            self._failures.popleft()
        return len(self._failures)

    @property
    def state_code(self) -> int:
        return STATE_CODES[self.state]
