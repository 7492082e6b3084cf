"""Block-paged KV pool: the host-side allocator behind paged serving.

Copied from the JAX package's ``engine/kv_pool.py``. One shared
``[n_layers, n_blocks, page, KV, hd]`` cache plus per-slot *block
tables* replace per-slot dense regions: a slot owns exactly the pages
its live positions span.

This module is the HOST truth: a free-list allocator with per-block
refcounts. Device tensors never carry ownership — the scheduler thread
is the single writer. Sharing (radix-tree prefix reuse,
engine/radix_cache.py) and copy-on-write both reduce to refcount edges
here:

- a *shared* full block appears in several slots' tables at refcount
  ``holders`` — decode never writes positions below a slot's live length,
  so shared full pages are read-only by construction;
- a *partially-filled tail* block can NOT be shared (its owner keeps
  writing rows into it), so mapping a cached partial page copies the
  matched rows into a fresh block first (``cow_copies_total``).

``HostBlockStore`` is the host-RAM second tier behind the radix tree's
demotion path (``HOST_KV_BLOCKS``). Cold cached pages are *demoted*
there (CRC32 stamped at demote) instead of discarded, and
``RadixCache.match`` transparently *onloads* them back — with checksum
verification, so a corrupt host copy can only ever cost a suffix
re-prefill, never a wrong transcript. The store is id-addressed (host
block ids are an independent namespace from device block ids) and, like
the pool, is host truth under the single-writer discipline; the ``check``
methods together assert exact balance across both tiers. Both are pure
numpy, copied from the JAX package with its counter names (``/metrics``
and the incident watcher read them).
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class PoolExhausted(RuntimeError):
    """No free block and nothing evictable — the caller decides policy
    (the batcher finishes the slot at its current length; admission
    retries after radix eviction)."""


def pages_for(n_tokens: int, page: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV rows."""
    return -(-max(0, n_tokens) // page)


def alloc_with_evict(pool: "BlockPool", radix, n: int):
    """Allocate ``n`` blocks with radix-eviction backpressure: cached
    blocks are reclaimable capacity, so allocation only truly fails once
    the tree has nothing left to give back. Returns None on failure
    (caller policy: truncate the slot / fail the admission)."""
    try:
        return pool.alloc(n)
    except PoolExhausted:
        if radix is not None and radix.evict_for(n):
            try:
                return pool.alloc(n)
            except PoolExhausted:  # pragma: no cover - defensive
                return None
        return None


def map_prefix(pool: "BlockPool", radix, ids: Sequence[int], *,
               match_all: bool = False, cow=None):
    """Build one slot's block chain for token sequence ``ids`` — THE
    shared admission path (run verbatim by the jax batcher and the fake
    engine, so refcount behaviour can never diverge between them):

    1. radix-match the longest cached prefix; full blocks map SHARED
       (refcounted, read-only by the decode-writes-only-forward
       invariant),
    2. a matched partial tail copy-on-writes into a fresh private block
       (``cow(src, dst, rows)`` does the device copy; the fake passes
       None — its KV is fictional, only the accounting is real),
    3. fresh blocks cover the remaining pages.

    Returns ``(blocks, m)``: the table blocks in page order and the
    count of tokens whose KV is already valid (prefill starts at m).
    Admissions pass match_all=False — the LAST token must run forward
    for its logits; replays pass True (the carry token is forced).
    Raises PoolExhausted with every ref released on failure."""
    page = pool.page
    blocks: List[int] = []
    m = 0
    if radix is not None:
        upto = len(ids) if match_all else max(0, len(ids) - 1)
        mr = radix.match(ids[:upto])
        blocks = list(mr.blocks)
        m = len(blocks) * page
        if mr.tail_block is not None:
            c = alloc_with_evict(pool, radix, 1)
            if c is None:
                pool.decref([mr.tail_block])
                if blocks:
                    pool.decref(blocks)
                raise PoolExhausted("kv pool exhausted (tail COW)")
            if cow is not None:
                cow(mr.tail_block, c[0], mr.tail_rows)
            pool.decref([mr.tail_block])
            pool.note_cow()
            blocks += c
            m += mr.tail_rows
    grow = pages_for(len(ids), page) - len(blocks)
    if grow > 0:
        fresh = alloc_with_evict(pool, radix, grow)
        if fresh is None:
            if blocks:
                pool.decref(blocks)
            raise PoolExhausted(f"kv pool exhausted ({grow} blocks short)")
        blocks += fresh
    return blocks, m


@dataclasses.dataclass
class PoolStats:
    n_blocks: int
    page: int
    free: int
    live: int
    cached: int
    shared_mapped_total: int
    cow_copies_total: int
    exhausted_total: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class BlockPool:
    """Free-list block allocator with refcounts.

    Refcount semantics: one count per *holder* — each slot table that maps
    the block, plus (at most) one for the radix tree that caches it.
    ``alloc`` hands out blocks at refcount 1; ``incref`` adds holders;
    ``decref`` removes them and returns blocks that hit zero to the free
    list. Double-free and negative-refcount are hard errors, not warnings:
    an accounting bug here corrupts KV silently (a freed block re-issued
    while a stale table still maps it), so the invariant check must be
    louder than the symptom.
    """

    def __init__(self, n_blocks: int, page: int):
        if n_blocks < 1:
            raise ValueError("KV pool needs at least 1 block")
        if page < 1:
            raise ValueError("KV pool page must be >= 1")
        self.n_blocks = int(n_blocks)
        self.page = int(page)
        self._ref = np.zeros((self.n_blocks,), np.int64)
        self._free: deque = deque(range(self.n_blocks))
        # Counters (cumulative; delta-mirrored into Prometheus at scrape).
        self.shared_mapped_total = 0   # shared-block mappings handed out
        self.cow_copies_total = 0      # partial-tail copy-on-write copies
        self.exhausted_total = 0       # allocation failures (after evict)

    def carry_counters(self, prev: "BlockPool") -> None:
        """Inherit the cumulative counters from a previous pool
        generation (containment reset rebuilds the allocator world):
        the /metrics delta-mirror compares against last-seen totals, so
        a zeroed counter would freeze the Prometheus series until the
        new generation re-exceeded the old value."""
        self.shared_mapped_total = prev.shared_mapped_total
        self.cow_copies_total = prev.cow_copies_total
        self.exhausted_total = prev.exhausted_total

    # ------------------------------------------------------------ alloc

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        """Pop ``n`` free blocks at refcount 1. All-or-nothing: a partial
        grab under pressure would leak on the error path."""
        if n <= 0:
            return []
        if len(self._free) < n:
            self.exhausted_total += 1
            raise PoolExhausted(
                f"KV pool exhausted: want {n} blocks, {len(self._free)} "
                f"free of {self.n_blocks}")
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks: Iterable[int]) -> None:
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(
                    f"incref of free block {b} (use-after-free)")
            self._ref[b] += 1

    def decref(self, blocks: Iterable[int]) -> List[int]:
        """Drop one holder per block; returns the blocks that reached
        refcount 0 (now back on the free list)."""
        freed: List[int] = []
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def ref(self, block: int) -> int:
        return int(self._ref[block])

    def note_shared(self, n: int) -> None:
        if n > 0:
            self.shared_mapped_total += n

    def note_cow(self, n: int = 1) -> None:
        self.cow_copies_total += n

    # ------------------------------------------------------- accounting

    def stats(self, cached_blocks: Sequence[int] = ()) -> PoolStats:
        """State classification for the kv_pool_blocks{state} gauges:
        ``free`` (refcount 0), ``cached`` (held ONLY by the radix tree),
        ``live`` (held by at least one slot). ``cached_blocks`` is the
        tree's block set (the pool itself is holder-agnostic)."""
        cached = sum(1 for b in set(cached_blocks) if self._ref[b] == 1)
        free = len(self._free)
        return PoolStats(
            n_blocks=self.n_blocks,
            page=self.page,
            free=free,
            live=self.n_blocks - free - cached,
            cached=cached,
            shared_mapped_total=self.shared_mapped_total,
            cow_copies_total=self.cow_copies_total,
            exhausted_total=self.exhausted_total,
        )

    def check(self, holders: Dict[int, int], *,
              host: Optional["HostBlockStore"] = None,
              host_holders: Optional[Dict[int, int]] = None) -> None:
        """Assert the books balance exactly against an externally-computed
        holder count per block (slots' tables + tree references): every
        block is either free (refcount 0, on the free list once) or
        accounted for by exactly its holders — no leak, no double-free.

        Passing ``host``/``host_holders`` extends the exact-balance
        assertion across the second tier: every resident host block must
        be held by exactly one radix node and vice versa."""
        free_set = list(self._free)
        if len(free_set) != len(set(free_set)):
            raise AssertionError("free list holds a block twice")
        for b in range(self.n_blocks):
            want = int(holders.get(b, 0))
            have = int(self._ref[b])
            if have != want:
                raise AssertionError(
                    f"block {b}: refcount {have} != {want} holders")
            on_free = b in self._free
            if (have == 0) != on_free:
                raise AssertionError(
                    f"block {b}: refcount {have} but "
                    f"{'on' if on_free else 'off'} the free list")
        if host is not None:
            host.check(host_holders or {})


def check_host_tier(host_kv_blocks: int, kv_pool: bool,
                    radix_cache: bool) -> None:
    """The host tier's settings, with the JAX config's errors: a negative
    capacity, and a tier without the block pool and the radix tree it
    demotes from. The config and the engine both call it: where the JAX
    engine quietly builds no store, the port refuses."""
    if host_kv_blocks < 0:
        raise ValueError(
            f"HOST_KV_BLOCKS must be >= 0 (0 disables the host "
            f"tier), got {host_kv_blocks}")
    if host_kv_blocks > 0 and not (kv_pool and radix_cache):
        raise ValueError(
            "HOST_KV_BLOCKS requires KV_POOL=true and "
            "RADIX_CACHE=true (the host tier is the radix tree's "
            "demotion target — without the tree there is nothing "
            "to demote)")


class HostBlockStore:
    """Host-RAM second KV tier.

    Holds demoted radix pages as numpy payloads keyed by *host block id*
    (an id namespace independent of device block indices — a host id is
    never valid in a slot table). Every ``put`` stamps a CRC32 over the
    payload bytes; promotion verifies it before the page re-enters the
    device tier, so silent host-RAM corruption degrades to a counted
    suffix re-prefill instead of a wrong transcript.

    Ownership is exactly-one-holder: each resident id is held by exactly
    one radix node (``RadixCache`` keeps the reverse map). There is no
    refcounting here — host pages are cache-only, never slot-mapped.
    Counters are cumulative and delta-mirrored into Prometheus, same as
    the pool's.
    """

    #: closed cause set for onload_fail_total — the causes are metric
    #: labels, so the set must be bounded by construction.
    ONLOAD_FAIL_CAUSES = ("corrupt", "exhausted")

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError("host KV block capacity must be >= 0")
        self.capacity = int(capacity)
        self._data: Dict[int, np.ndarray] = {}
        self._crc: Dict[int, int] = {}
        self._ids = itertools.count(1)
        # Counters (cumulative; delta-mirrored at /metrics scrape).
        self.demoted_total = 0        # device -> host copies stored
        self.onloaded_total = 0       # host -> device promotes (verified)
        self.adopted_total = 0        # host copy superseded by an
        #                               insert-path device block (free
        #                               promotion — no onload needed)
        self.dropped_total = 0        # host-LRU drops + discarded demotes
        self.offload_fail_total = 0   # offload:fail drills / demote aborts
        self.onload_fail_total: Dict[str, int] = {
            c: 0 for c in self.ONLOAD_FAIL_CAUSES}

    def carry_counters(self, prev: "HostBlockStore") -> None:
        """Inherit cumulative counters across a containment reset (both
        tiers rebuild — see BlockPool.carry_counters for why totals must
        never go backwards under the delta-mirror)."""
        self.demoted_total = prev.demoted_total
        self.onloaded_total = prev.onloaded_total
        self.adopted_total = prev.adopted_total
        self.dropped_total = prev.dropped_total
        self.offload_fail_total = prev.offload_fail_total
        self.onload_fail_total = dict(prev.onload_fail_total)

    # ------------------------------------------------------------ storage

    @property
    def used(self) -> int:
        return len(self._data)

    @property
    def free_count(self) -> int:
        return self.capacity - len(self._data)

    def put(self, data: np.ndarray) -> int:
        """Store one demoted page; returns its host block id. The CRC is
        stamped over the exact bytes stored — the promote path recomputes
        it over what it reads back. Raises when full (the radix demote
        path makes room FIRST; a full put is an accounting bug)."""
        if self.free_count < 1:
            raise RuntimeError(
                f"host block store full ({self.used}/{self.capacity}); "
                f"demote must make room before putting")
        buf = np.ascontiguousarray(data)
        hbid = next(self._ids)
        self._data[hbid] = buf
        self._crc[hbid] = zlib.crc32(buf.tobytes())
        self.demoted_total += 1
        return hbid

    def get(self, hbid: int) -> np.ndarray:
        if hbid not in self._data:
            raise RuntimeError(
                f"host block {hbid} not resident (use-after-free)")
        return self._data[hbid]

    def verify(self, hbid: int, data: np.ndarray) -> bool:
        """Does ``data`` still match the checksum stamped at demote?"""
        return (zlib.crc32(np.ascontiguousarray(data).tobytes())
                == self._crc.get(hbid))

    def free(self, hbid: int) -> None:
        if hbid not in self._data:
            raise RuntimeError(f"double free of host block {hbid}")
        del self._data[hbid]
        del self._crc[hbid]

    # --------------------------------------------------------- accounting

    def note_dropped(self, n: int = 1) -> None:
        self.dropped_total += n

    def note_onload_fail(self, cause: str) -> None:
        if cause not in self.ONLOAD_FAIL_CAUSES:
            raise ValueError(
                f"unknown onload-fail cause {cause!r}; "
                f"valid: {self.ONLOAD_FAIL_CAUSES}")
        self.onload_fail_total[cause] += 1

    def stats(self) -> dict:
        """The /health ``host_tier`` subsection (cheap host counters,
        never a payload walk — same rule as PoolStats)."""
        return {
            "capacity": self.capacity,
            "used": self.used,
            "free": self.free_count,
            "demoted_total": self.demoted_total,
            "onloaded_total": self.onloaded_total,
            "adopted_total": self.adopted_total,
            "dropped_total": self.dropped_total,
            "offload_fail_total": self.offload_fail_total,
            "onload_fail_total": dict(self.onload_fail_total),
        }

    def check(self, holders: Dict[int, int]) -> None:
        """Exact-balance assertion for the host tier: every resident id
        is held by exactly one node, every held id is resident, and the
        CRC table tracks the payload table one-to-one."""
        held = {h for h, n in holders.items() if n > 0}
        for hbid, n in holders.items():
            if n <= 0:
                continue
            if n != 1:
                raise AssertionError(
                    f"host block {hbid}: {n} holders (exactly one radix "
                    f"node may hold a host block)")
            if hbid not in self._data:
                raise AssertionError(
                    f"host block {hbid} held but not resident "
                    f"(use-after-free)")
        extra = set(self._data) - held
        if extra:
            raise AssertionError(
                f"host blocks resident but unheld (leak): {sorted(extra)}")
        if set(self._data) != set(self._crc):
            raise AssertionError("host CRC table out of sync with payloads")
        if len(self._data) > self.capacity:
            raise AssertionError(
                f"host store over capacity: {len(self._data)} > "
                f"{self.capacity}")
