"""Radix tree over token prefixes, backed by the block-paged KV pool.

SGLang's RadixAttention sharing model over this repo's block pool layout
(engine/kv_pool.py): the tree maps token prefixes to the pool blocks
holding their KV, so N concurrent users sharing the system prompt cost
one block set, and turn N+1 of a multi-turn ``/execute`` agent loop —
which re-sends its entire history — prefills only the unmatched suffix
instead of recomputing everything. This replaces the single-resident-
prefix ``engine/prefix_cache.py`` model in pool mode (the dense KV ladder
keeps the old PrefixKV splice).

Shape of the tree (page-granular trie + partial tails):

- Every edge is exactly ONE full page of tokens (``page`` ids), keyed by
  the page's token tuple; the node holds the pool block containing that
  page's KV. Node boundaries therefore always fall on page multiples, so
  a matched path maps straight into a slot's block table with zero
  copying — full blocks are shared read-only (decode never writes below
  a slot's live length) under one refcount each.
- A node may additionally hold one *tail*: a partial page (tokens, block,
  rows) — the remainder of the deepest inserted sequence below that
  node. A tail match cannot be shared in place (the new owner will write
  rows into that page as it decodes), so the caller copy-on-writes the
  matched rows into a fresh block (``BlockPool.note_cow``). One tail per
  node, latest-wins on divergence: tails exist for the agent-loop resume
  case, where the newest continuation is the one that returns.

Eviction is refcount-aware block reclamation, not whole-entry deletion:
the LRU walk drops childless nodes (tails first), decref'ing their blocks
— a block still mapped by a live slot survives at refcount >= 1 and only
its *cached* state ends. ``max_blocks`` bounds the tree's held blocks
(RADIX_LRU_BLOCKS); ``evict_for`` frees pool pressure on demand.

Two-tier demotion: with a ``HostBlockStore`` attached, the
eviction walk *demotes* a cold page to host RAM (CRC32 stamped)
instead of discarding it — the node stays in the tree holding a host
block id (``_Node.host``) and no device block. Host-resident nodes form
bottom-hanging subtrees by construction: a node may give up its device
block only once ALL its children are host-resident (or it has none), and
``match`` promotes top-down, so a host node's parent is never below it.
``match`` transparently re-onloads host pages it walks into — verified
against the demote-time checksum; a corrupt or allocation-starved onload
ends the match there (the caller prefills the suffix — zero failed
requests, counted per cause), and a corrupt page's whole host subtree is
dropped. The LRU clock spans both tiers: when the host store is full,
host leaves older than the incoming demote are dropped first; an
incoming page older than every resident one is discarded, exactly the
single-tier behaviour. ``offload:fail`` / ``onload:corrupt`` drill
points (testing/faults.py) are consumed through the duck-typed
``faults`` hook so both engines inherit them.

Host-side, numpy/stdlib only; single-writer (scheduler thread / event
loop) like the pool itself.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .kv_pool import BlockPool, HostBlockStore, alloc_with_evict


@dataclasses.dataclass
class MatchResult:
    """One admission's view of a prefix match.

    ``blocks`` are full shared pages, already incref'd FOR THE CALLER
    (map them into the slot table as-is). ``tail_block``/``tail_rows``
    name a partial page whose first ``tail_rows`` KV rows match — also
    incref'd; the caller must copy those rows into a fresh block and
    ``decref([tail_block])`` once the copy has executed. ``n_tokens`` =
    matched tokens total (full pages + tail rows)."""

    n_tokens: int = 0
    blocks: List[int] = dataclasses.field(default_factory=list)
    tail_block: Optional[int] = None
    tail_rows: int = 0


class _Node:
    __slots__ = ("children", "block", "host", "tail", "parent", "key",
                 "last")

    def __init__(self, parent: Optional["_Node"], key: Optional[tuple],
                 block: Optional[int]):
        self.children: Dict[tuple, _Node] = {}
        self.block = block           # pool block of this node's page
        # Host tier: exactly one of block/host is set for a
        # non-root node. host is the HostBlockStore id of the demoted
        # page; block is None while host-resident.
        self.host: Optional[int] = None
        self.parent = parent
        self.key = key               # page token tuple (None at root)
        # (tokens tuple, block id, rows) — the partial page below this
        # node, or None. Tails are never demoted (a partial page is the
        # least shareable KV — it drops first instead).
        self.tail: Optional[Tuple[tuple, int, int]] = None
        self.last = 0                # LRU stamp (monotonic, BOTH tiers)


class RadixCache:
    def __init__(self, pool: BlockPool, *, max_blocks: int = 0,
                 host_store: Optional[HostBlockStore] = None,
                 offload_fn=None, onload_fn=None, faults=None):
        self.pool = pool
        self.page = pool.page
        # Host tier: demote target for cold pages. offload_fn
        # (block -> np.ndarray) reads the page's device KV at demote;
        # onload_fn(block, data) writes it back at promote. The fake
        # engine passes neither — its payload is the page's token tuple,
        # so the checksum round-trip is still real. ``faults`` is the
        # duck-typed injector view (offload_fail()/onload_corrupt()).
        self.host_store = host_store if (
            host_store is not None and host_store.capacity > 0) else None
        self.offload_fn = offload_fn
        self.onload_fn = onload_fn
        self.faults = faults
        # hbid -> node holding it (exactly one — the host-tier ownership
        # invariant HostBlockStore.check asserts).
        self._host_nodes: Dict[int, _Node] = {}
        # LRU stamp of the match walk currently in flight: eviction
        # triggered by a mid-walk promote must never demote/drop the
        # walk's own path (the recorded blocks are incref'd in bulk only
        # at the end). 0 = no walk in flight.
        self._protect_stamp = 0
        # True while clear() drains: the reset condemns cached KV, so
        # eviction must plain-drop, never demote it into the host store.
        self._demote_suspended = False
        # 0 = auto: a quarter of the pool may sit cached — enough to keep
        # the system prompt + recent agent histories hot without starving
        # live admissions.
        self.max_blocks = int(max_blocks) if max_blocks > 0 \
            else max(1, pool.n_blocks // 4)
        self._root = _Node(None, None, None)
        self._clock = itertools.count(1)
        # block id -> number of tree edges holding it (a block can be
        # cached both as a node's page and as a tail while a sequence
        # grows through it; each edge carries its own pool ref).
        self._held: Dict[int, int] = {}
        # Maintained node counter: /health reads stats() from the HTTP
        # thread while the scheduler mutates the tree, so the cheap
        # surfaces must never WALK it (a DFS racing an insert raises
        # "dict changed size during iteration").
        self._nodes = 0
        self.hit_tokens_total = 0
        self.miss_tokens_total = 0
        self.insertions_total = 0
        self.evicted_blocks_total = 0

    def carry_counters(self, prev: "RadixCache") -> None:
        """Inherit cumulative counters across an engine reset (same
        rationale as BlockPool.carry_counters — the /metrics
        delta-mirror must never see totals go backwards)."""
        self.hit_tokens_total = prev.hit_tokens_total
        self.miss_tokens_total = prev.miss_tokens_total
        self.insertions_total = prev.insertions_total
        self.evicted_blocks_total = prev.evicted_blocks_total

    # ------------------------------------------------------------- match

    def cached_block_count(self) -> int:
        return len(self._held)          # len() is atomic under the GIL

    def cached_blocks(self) -> Set[int]:
        """Snapshot of the tree-held block set. Safe to call from a
        NON-scheduler thread (/health, /metrics): copying a dict's keys
        while the owner resizes it can raise RuntimeError — retry, and
        degrade to empty rather than 500 the probe (the scrape is a
        gauge, not an invariant check)."""
        for _ in range(4):
            try:
                return set(self._held)
            except RuntimeError:        # pragma: no cover - racy resize
                continue
        return set()                    # pragma: no cover - racy resize

    def _hold(self, block: int) -> None:
        self.pool.incref([block])
        self._held[block] = self._held.get(block, 0) + 1

    def _release(self, block: int) -> None:
        n = self._held.get(block, 0) - 1
        if n <= 0:
            self._held.pop(block, None)
        else:
            self._held[block] = n
        self.pool.decref([block])
        self.evicted_blocks_total += 1

    def node_count(self) -> int:
        return self._nodes              # maintained, never a tree walk

    def match(self, ids: Sequence[int]) -> MatchResult:
        """Longest cached prefix of ``ids``: full pages walked exactly,
        then at most one partial-tail match. Matched blocks are incref'd
        for the caller (see MatchResult). Counters: ``hit_tokens_total``
        gains the match, ``miss_tokens_total`` the unmatched remainder.

        Host-resident pages on the path are transparently promoted
        (checksum-verified onload); a failed promote — device
        tier full even after eviction, or a corrupt host copy — ends the
        match there and the caller prefills the suffix, so the host tier
        can degrade a hit into a prefill but never fail a request."""
        page = self.page
        node, n = self._root, 0
        blocks: List[int] = []
        stamp = next(self._clock)
        node.last = stamp
        self._protect_stamp = stamp
        try:
            while len(ids) - n >= page:
                child = node.children.get(tuple(ids[n:n + page]))
                if child is None:
                    break
                child.last = stamp
                if child.block is None and not self._promote(child):
                    break
                blocks.append(child.block)
                node = child
                n += page
        finally:
            self._protect_stamp = 0
        tail_block, tail_rows = None, 0
        if node.tail is not None:
            t_tokens, t_block, t_rows = node.tail
            limit = min(t_rows, len(ids) - n)
            common = 0
            while common < limit and t_tokens[common] == ids[n + common]:
                common += 1
            if common > 0:
                tail_block, tail_rows = t_block, common
        matched = n + tail_rows
        self.hit_tokens_total += matched
        self.miss_tokens_total += len(ids) - matched
        if blocks:
            self.pool.incref(blocks)
            self.pool.note_shared(len(blocks))
        if tail_block is not None:
            self.pool.incref([tail_block])
        return MatchResult(n_tokens=matched, blocks=blocks,
                           tail_block=tail_block, tail_rows=tail_rows)

    # ------------------------------------------------------------ insert

    def insert(self, ids: Sequence[int], blocks: Sequence[int]) -> int:
        """Cache the chain ``ids`` whose KV lives in ``blocks`` (block i
        holds rows [i*page, (i+1)*page) of the sequence; the last block
        may be partial). The tree takes its OWN refs on blocks it newly
        caches — the caller's refs are untouched (a finishing slot
        releases its table afterwards and shared blocks decay to
        cached). Existing nodes on the path are reused (their resident
        block stays; the caller's duplicate KV for that page is simply
        not cached). Returns the number of blocks newly cached."""
        page = self.page
        if len(blocks) < pages_needed(len(ids), page):
            raise ValueError(
                f"chain of {len(ids)} tokens needs "
                f"{pages_needed(len(ids), page)} blocks, got {len(blocks)}")
        node, taken = self._root, 0
        stamp = next(self._clock)
        node.last = stamp
        full = len(ids) // page
        for i in range(full):
            key = tuple(ids[i * page:(i + 1) * page])
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                self._hold(b)
                child = _Node(node, key, b)
                node.children[key] = child
                self._nodes += 1
                taken += 1
            elif child.block is None:
                # Host-resident page on the insert path: the
                # caller just decoded through this page, so its device
                # block carries the same KV — adopt it and free the host
                # copy (a promotion that costs no onload).
                self._adopt(child, blocks[i])
                taken += 1
            child.last = stamp
            node = child
        rows = len(ids) % page
        if rows:
            t_tokens = tuple(ids[full * page:])
            b = blocks[full]
            cur = node.tail
            keep_existing = (
                cur is not None and len(cur[0]) >= rows
                and cur[0][:rows] == t_tokens)
            if keep_existing:
                pass             # the resident tail already covers this one
            elif cur is not None and cur[1] == b:
                # Same physical block, longer/different rows (a preempted
                # slot finishing re-inserts its own tail): the tree's ref
                # already covers it — just update the view.
                node.tail = (t_tokens, b, rows)
            else:
                self._hold(b)
                if cur is not None:
                    self._drop_tail(node)
                node.tail = (t_tokens, b, rows)
                taken += 1
        self.insertions_total += 1
        self.enforce_budget()
        return taken

    def _drop_tail(self, node: _Node) -> None:
        if node.tail is None:
            return
        _, b, _ = node.tail
        node.tail = None
        self._release(b)

    # ---------------------------------------------------------- eviction

    def _protected(self, node: _Node) -> bool:
        """Is ``node`` on the match walk currently in flight? Promotion
        can trigger eviction mid-walk (alloc_with_evict); the walk's own
        path — every node stamped with the walk's clock value — must
        survive it, since the caller's bulk incref happens only at the
        end of the match."""
        return self._protect_stamp > 0 and node.last >= self._protect_stamp

    def _demotable(self, node: _Node) -> bool:
        """May ``node`` give up its device block? Only once no descendant
        chain still needs it: all children host-resident (or none), no
        tail, not the walk-protected path. An interior eviction would
        orphan device descendants' chains — but a node whose entire
        subtree already lives in the host tier hangs at the bottom of the
        device tree, so demoting/dropping it keeps both tiers coherent."""
        return (node is not self._root and node.parent is not None
                and node.tail is None and node.block is not None
                and not self._protected(node)
                and all(c.block is None for c in node.children.values()))

    def _evictables(self) -> List[Tuple[int, int, _Node]]:
        """(last, kind, node) for every droppable unit, LRU-first. Tails
        rank before their node's block (kind 0 < 1) so partial pages —
        the least shareable KV — reclaim first at equal recency; only
        nodes passing ``_demotable`` may drop their block (an interior
        eviction would orphan descendants' chains)."""
        out: List[Tuple[int, int, _Node]] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.tail is not None and not self._protected(node):
                out.append((node.last, 0, node))
            if self._demotable(node):
                out.append((node.last, 1, node))
        out.sort(key=lambda t: (t[0], t[1]))
        return out

    def _drop_node(self, node: _Node) -> None:
        del node.parent.children[node.key]
        self._nodes -= 1
        self._release(node.block)
        if node.children:
            # All host-resident (the _demotable precondition): dropping
            # this interior node orphans its host subtree — purge it so
            # the host store never holds unreachable pages.
            for child in list(node.children.values()):
                self._purge_host_subtree(child)
            node.children = {}

    def _evict_until(self, done) -> bool:
        """Evict strictly-LRU units until ``done()``: one evictables
        collection seeds a heap, and dropping a node lazily pushes its
        parent once it becomes droppable — O((n + evictions)·log n),
        not the O(n²) a full re-collect per block would cost on the
        scheduler hot path, while preserving exact LRU order (a freed
        leaf's OLDER parent must evict before a younger sibling chain).
        With a host store attached, "evict" means demote-to-host where
        the page qualifies (cold, unmapped, store has or can make room)
        and plain drop otherwise — either way the device block frees.
        Returns False once nothing evictable remains."""
        if done():
            return True
        heap = [(last, kind, i, node)
                for i, (last, kind, node) in enumerate(self._evictables())]
        heapq.heapify(heap)
        seq = len(heap)                  # tie-break for lazy pushes
        while not done():
            while heap:
                _, kind, _, node = heapq.heappop(heap)
                # Staleness: a unit may have been consumed by an earlier
                # drop in this run (e.g. its tail went first).
                if kind == 0:
                    if node.tail is None or self._protected(node):
                        continue
                    self._drop_tail(node)
                    if self._demotable(node):
                        # The tail was the node's last blocker — its
                        # block itself is evictable now.
                        heapq.heappush(heap, (node.last, 1, seq, node))
                        seq += 1
                else:
                    if (not self._demotable(node)
                            or node.parent.children.get(node.key)
                            is not node):
                        continue
                    parent = node.parent
                    if not self._demote_node(node):
                        self._drop_node(node)
                    if self._demotable(parent):
                        heapq.heappush(heap,
                                       (parent.last, 1, seq, parent))
                        seq += 1
                break
            else:
                return False             # heap drained, target unmet
        return True

    # ------------------------------------------------------------ host tier

    def _fault(self, name: str) -> bool:
        """Consume a one-shot drill point off the duck-typed injector
        view (offload_fail / onload_corrupt); False when no injector or
        the point is not armed."""
        fn = getattr(self.faults, name, None)
        return bool(fn()) if callable(fn) else False

    def _page_payload(self, node: _Node) -> np.ndarray:
        """The bytes that travel to the host tier for one page: the
        device KV rows when an offload_fn is wired (the engine), else
        the page's token tuple (fake engine) — fictional KV, but a real
        checksum round-trip either way."""
        if self.offload_fn is not None:
            return np.asarray(self.offload_fn(node.block))
        return np.asarray(node.key, dtype=np.int64)

    def _oldest_host_leaf(self, max_last: int) -> Optional[_Node]:
        """LRU victim for host-store room-making: the stalest host leaf
        no younger than ``max_last`` (the incoming demote's stamp — the
        LRU spans both tiers, so a page colder than everything resident
        is discarded rather than displacing warmer pages)."""
        best: Optional[_Node] = None
        for cand in self._host_nodes.values():
            if cand.children or self._protected(cand):
                continue
            if cand.last > max_last:
                continue
            if best is None or cand.last < best.last:
                best = cand
        return best

    def _drop_host_leaf(self, node: _Node) -> None:
        del node.parent.children[node.key]
        self._nodes -= 1
        self.host_store.free(node.host)
        self._host_nodes.pop(node.host, None)
        self.host_store.note_dropped()
        node.host = None

    def _purge_host_subtree(self, node: _Node) -> None:
        """Free every host page under (and including) ``node``, which is
        already detached from its parent — used when an interior drop or
        a corrupt onload invalidates the whole chain below a point."""
        stack = [node]
        while stack:
            cur = stack.pop()
            stack.extend(cur.children.values())
            cur.children = {}
            self._nodes -= 1
            if cur.tail is not None:     # pragma: no cover - defensive
                self._drop_tail(cur)
                self._nodes += 1         # _drop_tail is not a node drop
            if cur.host is not None:
                self.host_store.free(cur.host)
                self._host_nodes.pop(cur.host, None)
                self.host_store.note_dropped()
                cur.host = None
            elif cur.block is not None:  # pragma: no cover - defensive
                self._release(cur.block)

    def _demote_node(self, node: _Node) -> bool:
        """Device→host demotion of one cold page: copy the page payload
        into the host store (CRC32 stamped by ``put``), release
        the device block, and keep the node in the tree host-resident.
        Returns False when the page must be plain-dropped instead — host
        tier off, the block still mapped by a live slot (demoting would
        free no HBM), the ``offload:fail`` drill, or a store full of
        strictly warmer pages."""
        store = self.host_store
        if store is None or self._demote_suspended:
            return False
        if self.pool.ref(node.block) != 1:
            return False
        if self._fault("offload_fail"):
            store.offload_fail_total += 1
            return False
        while store.free_count < 1:
            victim = self._oldest_host_leaf(node.last)
            if victim is None:
                store.note_dropped()
                return False
            self._drop_host_leaf(victim)
        data = self._page_payload(node)
        hbid = store.put(data)
        node.host = hbid
        self._host_nodes[hbid] = node
        b = node.block
        node.block = None
        # The tree's device hold ends; ref==1 (checked above) means the
        # block actually frees. Not an eviction for counting purposes —
        # the page survives, demoted_total tracks it.
        n = self._held.get(b, 0) - 1
        if n <= 0:
            self._held.pop(b, None)
        else:                            # pragma: no cover - defensive
            self._held[b] = n
        self.pool.decref([b])
        return True

    def _promote(self, node: _Node) -> bool:
        """Host→device promotion during a match walk: verify the page
        against its demote-time checksum, allocate a device block (with
        eviction backpressure — which may itself demote colder pages),
        onload, and hand the alloc's ref to the tree. On a corrupt page
        the node AND its host subtree drop (nothing below a bad page can
        be trusted); on allocation failure the host copy is kept for a
        later, less-pressured attempt. Either failure returns False —
        the match ends there and the caller prefills the suffix."""
        store = self.host_store
        hbid = node.host
        data = store.get(hbid)
        if self._fault("onload_corrupt"):
            # Flip one byte of a COPY of the payload: the real verify
            # path catches it, exactly as bit-rot in host RAM would.
            raw = bytearray(np.ascontiguousarray(data).tobytes())
            if raw:
                raw[0] ^= 0xFF
            data = np.frombuffer(
                bytes(raw), dtype=data.dtype).reshape(data.shape)
        if not store.verify(hbid, data):
            store.note_onload_fail("corrupt")
            del node.parent.children[node.key]
            self._purge_host_subtree(node)
            return False
        dev = alloc_with_evict(self.pool, self, 1)
        if dev is None:
            store.note_onload_fail("exhausted")
            return False
        b = dev[0]
        if self.onload_fn is not None:
            self.onload_fn(b, data)
        store.free(hbid)
        store.onloaded_total += 1
        self._host_nodes.pop(hbid, None)
        node.host = None
        node.block = b
        # alloc's refcount-1 becomes the tree's hold (no extra incref);
        # the caller's ref rides the match's bulk incref like any other
        # matched page.
        self._held[b] = self._held.get(b, 0) + 1
        return True

    def _adopt(self, node: _Node, block: int) -> None:
        """Insert-path promotion: the caller's device block already
        carries this page's KV, so the host copy is redundant — take the
        tree's own ref on the device block and free the host page."""
        self.host_store.free(node.host)
        self.host_store.adopted_total += 1
        self._host_nodes.pop(node.host, None)
        node.host = None
        node.block = block
        self._hold(block)

    def host_holders(self) -> Dict[int, int]:
        """Host-tier holder map for the cross-tier exact-balance check
        (each resident host block is held by exactly one node)."""
        return {hbid: 1 for hbid in self._host_nodes}

    def host_resident_blocks(self) -> int:
        return len(self._host_nodes)

    def enforce_budget(self) -> None:
        self._evict_until(lambda: len(self._held) <= self.max_blocks)

    def evict_for(self, n_free: int) -> bool:
        """Free pool pressure: evict LRU cached blocks until the pool has
        ``n_free`` free blocks or nothing cached remains. Returns True if
        the target was met. Evicting a block still mapped by a live slot
        drops only the CACHED state (refcount stays > 0) — it keeps
        evicting until actual free blocks materialize."""
        return self._evict_until(lambda: self.pool.free_count >= n_free)

    def clear(self) -> None:
        """Drop every cached block in BOTH tiers (engine reset: the
        pool's device arrays are being rebuilt and host copies of a
        possibly-poisoned generation cannot be trusted either, so the
        containment reset rebuilds the whole two-tier world). Demotion
        is suspended for the drain — clearing into the host store would
        smuggle condemned KV across the reset."""
        self._demote_suspended = True
        try:
            self._evict_until(lambda: not self._held and not self._nodes)
        finally:
            self._demote_suspended = False
        if self.host_store is not None:
            for hbid in list(self._host_nodes):
                self.host_store.free(hbid)
                self.host_store.note_dropped()
        self._host_nodes.clear()
        self._root = _Node(None, None, None)
        self._nodes = 0

    def stats(self) -> dict:
        body = {
            "nodes": self.node_count(),
            "cached_blocks": len(self._held),
            "max_blocks": self.max_blocks,
            "hit_tokens": self.hit_tokens_total,
            "miss_tokens": self.miss_tokens_total,
            "insertions": self.insertions_total,
            "evicted_blocks": self.evicted_blocks_total,
        }
        if self.host_store is not None:
            body["host_resident_nodes"] = len(self._host_nodes)
        return body


def pages_needed(n_tokens: int, page: int) -> int:
    return -(-max(0, n_tokens) // page)
