"""Request-lifecycle trace context: request ID + span API (a copy of the
JAX package's ``obs/trace.py``).

One ``Trace`` per HTTP request, created by the observability middleware
and finished when the response (or exception) leaves it. Spans carry
``time.monotonic()`` begin/end stamps relative to nothing — offsets are
computed against the trace's own t0 at serialization time, so clock
adjustments can never skew a timeline. Events are point-in-time
annotations ("cache: hit", "breaker: open") recorded from wherever the
trace travels; all mutation goes through one lock, so a thread may
annotate it too.

The active trace travels on the ``ContextVar`` below through the async
serving path (middleware, cache, breaker, engine call, executor):
asyncio copies the context into every task, so ``current_trace()``
works anywhere downstream of the middleware on the event loop. The
batched engine keeps the request's trace and annotates it from its
scheduler thread with the QoS ring's events (preempted, resumed,
replayed, expired, displaced, shed); the service
lays the queue, prefill and decode spans from each ``EngineResult``'s
timings.
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

#: phase names admitted into the ``request_phase_seconds`` histogram.
#: A fixed allowlist, NOT whatever span names show up — a bug (or a
#: hostile client header echoed into a span) must never mint unbounded
#: Prometheus label values.
PHASES = (
    "validate",      # body parse + pydantic + sanitation
    "queue_wait",    # submit → admission into a decode slot
    "prefill",       # prompt prefill (admission latency on the batcher)
    "decode",        # token generation
    "detokenize",    # token → text + engine/event-loop handoff
    "safety",        # output parsing + safety validation
    "execute",       # kubectl subprocess run (/execute)
    "cache",         # response-cache lookup serving a hit
    "fallback",      # rule-based degraded generation
    "respond",       # response model build + serialization
)

_RID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def new_request_id() -> str:
    """16 hex chars — short enough to quote in a bug report, random
    enough that collisions inside one flight-recorder window are moot."""
    return uuid.uuid4().hex[:16]


def sanitize_request_id(raw: Optional[str]) -> Optional[str]:
    """Echo a client-supplied X-Request-ID only when it is boringly safe:
    ≤64 chars of [A-Za-z0-9._-]. Anything else (header injection, log
    forging, 4 KB of junk) is discarded and a fresh ID is minted."""
    if raw and _RID_RE.match(raw):
        return raw
    return None


class Span:
    """One named interval inside a trace. ``t0``/``t1`` are raw
    ``time.monotonic()`` stamps; offsets are derived at read time."""

    __slots__ = ("name", "t0", "t1", "meta")

    def __init__(self, name: str, t0: float, t1: float,
                 meta: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = t0
        self.t1 = max(t1, t0)
        self.meta = meta or {}

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1000.0


class Trace:
    """Span timeline + event log for one request."""

    def __init__(self, request_id: str, method: str = "", path: str = ""):
        self.request_id = request_id
        self.method = method
        self.path = path
        self.t0 = time.monotonic()
        self.wall_start = time.time()
        self.status: Optional[int] = None
        self.error: Optional[str] = None
        # outcome flags the flight recorder filters/surfaces on
        self.shed = False
        self.degraded = False
        self.from_cache = False
        self._t_end: Optional[float] = None
        self._spans: List[Span] = []
        self._events: List[tuple] = []
        self._links: List[tuple] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ recording

    @contextmanager
    def span(self, name: str, **meta):
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self.add_span(name, t0, time.monotonic(), **meta)

    def add_span(self, name: str, t0: float, t1: float, **meta) -> None:
        """Record an interval from explicit monotonic stamps — used when a
        phase's boundaries are known after the fact (e.g. queue/prefill/
        decode reconstructed from an EngineResult's timings)."""
        with self._lock:
            self._spans.append(Span(name, t0, t1, meta or None))

    def event(self, message: str, **meta) -> None:
        """Point-in-time annotation; safe from any thread."""
        with self._lock:
            self._events.append((time.monotonic(), message, meta or None))

    def link(self, link_type: str, **meta) -> None:
        """Causal span link: a handoff where this request's execution
        moved — preempted out of a slot, migrated off a replica, raced
        on a hedge branch, a loser branch cancelled. Links are what
        stitch ONE timeline out of a request that crossed scheduler
        boundaries: every engine annotates the same Trace object (same
        process, same monotonic clock, so offsets reconcile for free),
        and the links name which segment each stretch of events belongs
        to — including branches that lost and would otherwise vanish.
        Safe from any thread, like ``event``."""
        with self._lock:
            self._links.append((time.monotonic(), link_type, meta or None))

    def finish(self, status: Optional[int] = None,
               error: Optional[str] = None) -> None:
        if status is not None:
            self.status = status
        if error is not None:
            self.error = error
        self._t_end = time.monotonic()

    # -------------------------------------------------------------- reading

    @property
    def duration_ms(self) -> float:
        end = self._t_end if self._t_end is not None else time.monotonic()
        return (end - self.t0) * 1000.0

    def phase_durations(self) -> Dict[str, float]:
        """name → total ms (same-named spans merged), insertion-ordered."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self._spans:
                out[s.name] = out.get(s.name, 0.0) + s.duration_ms
        return out

    def server_timing(self) -> str:
        """RFC 8941 Server-Timing value: ``queue_wait;dur=1.2, ...``.
        Span names are from code (never client input), so no escaping."""
        return ", ".join(
            f"{name};dur={dur:.2f}"
            for name, dur in self.phase_durations().items()
        )

    def summary(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "method": self.method,
            "path": self.path,
            "status": self.status,
            "duration_ms": round(self.duration_ms, 3),
            "shed": self.shed,
            "degraded": self.degraded,
            "from_cache": self.from_cache,
            "error": self.error,
            "start_time": self.wall_start,
        }

    def to_dict(self) -> Dict[str, Any]:
        """Full timeline — what /debug/requests/{id} serves. Offsets are
        milliseconds from request start."""
        with self._lock:
            spans = [
                {
                    "phase": s.name,
                    "start_ms": round((s.t0 - self.t0) * 1000.0, 3),
                    "end_ms": round((s.t1 - self.t0) * 1000.0, 3),
                    "duration_ms": round(s.duration_ms, 3),
                    **({"meta": s.meta} if s.meta else {}),
                }
                for s in sorted(self._spans, key=lambda s: s.t0)
            ]
            events = [
                {
                    "offset_ms": round((t - self.t0) * 1000.0, 3),
                    "message": msg,
                    **({"meta": meta} if meta else {}),
                }
                for t, msg, meta in self._events
            ]
            links = [
                {
                    "offset_ms": round((t - self.t0) * 1000.0, 3),
                    "type": link_type,
                    **({"meta": meta} if meta else {}),
                }
                for t, link_type, meta in self._links
            ]
        d = self.summary()
        d["spans"] = spans
        d["events"] = events
        d["links"] = links
        return d


# --------------------------------------------------------------- context

_CURRENT: contextvars.ContextVar[Optional[Trace]] = contextvars.ContextVar(
    "ai_agent_kubectl_tpu_torch_trace", default=None
)


def current_trace() -> Optional[Trace]:
    return _CURRENT.get()


@contextmanager
def use_trace(trace: Trace):
    token = _CURRENT.set(trace)
    try:
        yield trace
    finally:
        _CURRENT.reset(token)


def trace_event(message: str, **meta) -> None:
    """Annotate the active trace, if any — the no-trace case (unit tests
    driving a component directly, background threads) is free."""
    t = _CURRENT.get()
    if t is not None:
        t.event(message, **meta)
