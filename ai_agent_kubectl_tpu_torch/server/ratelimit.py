"""Per-client sliding-window rate limiting.

Replaces slowapi's ``Limiter`` (reference app.py:127-134, 298, 368) with a
from-scratch sliding-window counter keyed by remote address. The reference
applied the same limit twice (middleware default + per-route decorator,
quirk B3); here one enforcement point covers the rate-limited routes.

429 responses carry ``Retry-After`` and the conventional
``X-RateLimit-{Limit,Remaining,Reset}`` headers.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple


def ceil_seconds(seconds: float) -> int:
    """Whole-second ceiling for Retry-After-style header values (shared by
    the rate limiter and the overload-shed responses in server/app.py)."""
    return math.ceil(seconds) if seconds > 0 else 0


def client_key(remote: Optional[str], forwarded_for: Optional[str],
               trust_proxy: bool) -> str:
    """Rate-limit bucket key for one request.

    Behind a fronting router tier (the fleet deployment shape) every
    request arrives from ONE upstream peer IP — keying on it would give
    the whole user base a single shared quota. With ``trust_proxy``
    (TRUST_PROXY / TRUST_PROXY_HEADERS) the leftmost ``X-Forwarded-For``
    hop — the untrusted client as the first proxy saw it — keys the
    bucket instead. Without it the raw peer IP stays authoritative: a
    direct client could otherwise mint a fresh quota per request by
    forging the header."""
    if trust_proxy and forwarded_for:
        hops = [h.strip() for h in forwarded_for.split(",") if h.strip()]
        if hops:
            return hops[0]
    return remote or "unknown"


class SlidingWindowLimiter:
    """Classic sliding-window-log limiter: at most ``count`` events per
    ``window`` seconds per key. Exact (no bucketing artifacts), O(count)
    memory per active key, with idle-key garbage collection."""

    def __init__(
        self,
        count: int,
        window: float,
        timer: Callable[[], float] = time.monotonic,
        gc_interval: float = 60.0,
    ):
        if count < 1:
            raise ValueError("count must be >= 1")
        self.count = count
        self.window = window
        self._timer = timer
        self._events: Dict[str, Deque[float]] = {}
        self._gc_interval = gc_interval
        self._last_gc = timer()

    def _gc(self, now: float) -> None:
        if now - self._last_gc < self._gc_interval:
            return
        self._last_gc = now
        horizon = now - self.window
        dead = [k for k, dq in self._events.items() if not dq or dq[-1] <= horizon]
        for k in dead:
            del self._events[k]

    def check(self, key: str) -> Tuple[bool, int, float]:
        """Record an attempt for ``key``.

        Returns (allowed, remaining, retry_after_seconds). Only allowed
        events consume quota.
        """
        now = self._timer()
        self._gc(now)
        dq = self._events.get(key)
        if dq is None:
            dq = self._events[key] = deque()
        horizon = now - self.window
        while dq and dq[0] <= horizon:
            dq.popleft()
        if len(dq) >= self.count:
            retry_after = dq[0] + self.window - now
            return False, 0, max(retry_after, 0.0)
        dq.append(now)
        return True, self.count - len(dq), 0.0

    def headers(self, remaining: int, retry_after: float) -> Dict[str, str]:
        # X-RateLimit-Reset is delta-seconds until quota frees. The old
        # value was int(monotonic + retry_after) — a process-relative
        # timestamp no client could interpret.
        h = {
            "X-RateLimit-Limit": str(self.count),
            "X-RateLimit-Remaining": str(max(remaining, 0)),
            "X-RateLimit-Reset": str(ceil_seconds(retry_after)),
        }
        if retry_after > 0:
            h["Retry-After"] = str(max(1, ceil_seconds(retry_after)))
        return h
