"""TTL + LRU response cache with single-flight coalescing.

Replaces ``cachetools.TTLCache`` (reference app.py:124-125) with a
from-scratch implementation, and fixes the documented race (quirk B4,
SURVEY.md §2.3 / §5): the reference awaits the LLM between ``cache.get``
and ``cache[k] = v`` (app.py:312-322), so concurrent identical misses each
pay a full generation. ``single_flight`` coalesces them onto one in-flight
future per key.

This is the *service-layer* query→command cache (a copy of the JAX
package's ``server/cache.py``). Its device analog — the system-prompt
prefix-KV cache — lives in ``engine/prefix_cache.py``.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Dict, Generic, Hashable, Tuple, TypeVar

from ..obs.trace import trace_event

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_MISSING = object()


class TTLCache(Generic[K, V]):
    """LRU-evicting mapping whose entries expire ``ttl`` seconds after insert.

    Semantics match cachetools.TTLCache as used by the reference: per-entry
    expiry measured from insertion, LRU eviction at ``maxsize``, ``get``
    returns default on missing/expired.
    """

    def __init__(self, maxsize: int, ttl: float, timer: Callable[[], float] = time.monotonic):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        if ttl <= 0:
            raise ValueError("ttl must be > 0")
        self.maxsize = maxsize
        self.ttl = ttl
        self._timer = timer
        self._data: "OrderedDict[K, Tuple[float, V]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _expired(self, expires_at: float) -> bool:
        return self._timer() >= expires_at

    def _purge(self) -> None:
        now = self._timer()
        dead = [k for k, (exp, _) in self._data.items() if now >= exp]
        for k in dead:
            del self._data[k]

    def get(self, key: K, default: Any = None) -> Any:
        item = self._data.get(key, _MISSING)
        if item is _MISSING:
            self.misses += 1
            return default
        expires_at, value = item
        if self._expired(expires_at):
            del self._data[key]
            self.misses += 1
            return default
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key: K, value: V) -> None:
        self._purge()
        if key in self._data:
            del self._data[key]
        elif len(self._data) >= self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1
        self._data[key] = (self._timer() + self.ttl, value)

    # dict-style sugar matching the reference's usage (app.py:312,322)
    __setitem__ = put

    def __contains__(self, key: K) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def __len__(self) -> int:
        self._purge()
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()


class SingleFlight(Generic[K, V]):
    """Coalesce concurrent async computations per key.

    If a computation for ``key`` is already in flight, later callers await
    the same result instead of launching their own (fixes B4). The supplier
    runs in its *own task*, so a waiter disconnecting (handler cancellation)
    never cancels the shared computation out from under the other waiters —
    the generation completes and lands in the cache regardless. Failed
    computations are not cached; every waiter sees the same exception.
    """

    def __init__(self) -> None:
        self._inflight: Dict[K, "asyncio.Task[V]"] = {}

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    async def do(self, key: K, supplier: Callable[[], Awaitable[V]]) -> Tuple[V, bool]:
        """Return (value, shared) — shared=True when this call piggybacked on
        another caller's in-flight computation."""
        task = self._inflight.get(key)
        shared = task is not None
        if task is None:
            task = asyncio.get_running_loop().create_task(supplier())
            self._inflight[key] = task
            task.add_done_callback(lambda t: self._inflight.pop(key, None))
            # Don't let an all-waiters-cancelled failure surface as an
            # "exception was never retrieved" warning.
            task.add_done_callback(
                lambda t: t.exception() if not t.cancelled() else None
            )
        # shield: cancelling this caller must not cancel the shared task.
        return await asyncio.shield(task), shared


class CachedSingleFlight(Generic[K, V]):
    """TTL cache + single-flight, the composed service-layer lookup path."""

    def __init__(self, maxsize: int, ttl: float, timer: Callable[[], float] = time.monotonic):
        self.cache: TTLCache[K, V] = TTLCache(maxsize, ttl, timer)
        self.flight: SingleFlight[K, V] = SingleFlight()

    async def get_or_create(
        self, key: K, supplier: Callable[[], Awaitable[V]]
    ) -> Tuple[V, bool]:
        """Return (value, from_cache). Coalesced waiters report
        from_cache=True — from the caller's perspective the value was not
        generated for them."""
        cached: Any = self.cache.get(key, _MISSING)
        if cached is not _MISSING:
            trace_event("cache: hit")
            return cached, True

        async def fill() -> V:
            value = await supplier()
            self.cache.put(key, value)
            return value

        coalesced = key in self.flight._inflight
        trace_event("cache: miss — coalescing onto the in-flight generation"
                    if coalesced else "cache: miss — starting a generation")
        value, shared = await self.flight.do(key, fill)
        return value, shared
