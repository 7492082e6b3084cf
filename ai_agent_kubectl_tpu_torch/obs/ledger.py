"""Goodput ledger: classify every device decode step a request cost.

The reliability machinery deliberately burns device work —
masked wasted steps for dead slots, quarantine replays, preemption
exports, hedge losers, cross-replica migrations — and each subsystem
counts its own burn in its own counter. No surface answered the operator
question that matters at scale: *of every decode step the device executed,
how many became bytes a client kept, per tenant and lane?* This module
is that surface: one append-only ledger both engine schedulers (and the
fleet relay) feed at the exact points that already count these events,
with a hard conservation invariant — ``delivered`` plus every waste
class equals the total steps accounted.

Classes (closed set — Prometheus labels, cardinality bounded by
construction):

- ``delivered``       — decode steps whose token reached the client
                        (the goodput numerator; counted when a slot
                        finishes, from the emitted transcript)
- ``replayed``        — already-generated tokens re-derived by a
                        containment reset-and-replay or a cross-replica
                        migration re-splice (the recipient re-prefills
                        them — real device work that produced no new
                        client byte)
- ``preempted``       — generated tokens carried across a QoS
                        preempt-and-replay (same re-derivation cost,
                        different cause)
- ``hedge_loser``     — steps a losing hedge branch executed past the
                        shared resume prefix before it was cancelled
- ``wasted_masked``   — steps executed for already-terminated or freed
                        slots (the ``wasted_decode_steps_total`` family:
                        in-flight chunks dying by snapshot mismatch,
                        host-only finishes, legacy tail decode)
- ``quarantine_burn`` — tokens generated for a request that was then
                        terminally quarantined (its transcript is
                        discarded, never delivered)
- ``draft_rejected``  — speculative-decode draft proposals the 7B
                        verifier rejected (the 2B's step bought nothing;
                        the acceptance *rate* this implies is the
                        first-class /metrics signal of speculative decode)

Aggregation is per *lane* (the closed three-lane QoS set) for metrics,
and per *tenant* only in the ``/debug/ledger`` snapshot — tenants must
never become metric labels (the QoS cardinality rule). Tenant keys may
be API keys, so the ledger stores them **hashed** (``hash_tenant``), the
same form ``LOG_FORMAT=json`` stamps on log lines — a log grep and a
ledger row join on the same opaque key without either leaking the
credential.

Stdlib-only by design (same rule as the rest of ``obs``): the record
path is called from the batch scheduler thread per finish/waste event.
"""

from __future__ import annotations

import hashlib
import threading
from functools import lru_cache
from typing import Dict, List, Optional

#: the closed accounting-class set, goodput first.
CLASS_DELIVERED = "delivered"
CLASS_REPLAYED = "replayed"
CLASS_PREEMPTED = "preempted"
CLASS_HEDGE_LOSER = "hedge_loser"
CLASS_WASTED_MASKED = "wasted_masked"
CLASS_QUARANTINE_BURN = "quarantine_burn"
#: speculative decoding: draft-model proposals the verifier
#: rejected — the draft engine burned a step deriving a token the 7B
#: then re-sampled differently, so the work produced no client byte.
#: (Accepted drafts are the opposite: a transcript token that did NOT
#: cost its own target forward — they bill delivered like any other.)
CLASS_DRAFT_REJECTED = "draft_rejected"
LEDGER_CLASSES = (CLASS_DELIVERED, CLASS_REPLAYED, CLASS_PREEMPTED,
                  CLASS_HEDGE_LOSER, CLASS_WASTED_MASKED,
                  CLASS_QUARANTINE_BURN, CLASS_DRAFT_REJECTED)
WASTE_CLASSES = LEDGER_CLASSES[1:]

#: tenant-table overflow bucket: past ``max_tenants`` distinct keys, new
#: tenants aggregate here instead of growing the dict without bound (an
#: IP-rotating flood must not turn the debug snapshot into the very
#: cardinality leak the metric rule exists to prevent).
OVERFLOW_TENANT = "~overflow"


@lru_cache(maxsize=4096)
def hash_tenant(tenant: Optional[str]) -> str:
    """Stable opaque key for a tenant (12 hex chars of sha256).

    Tenant keys are API keys or client IPs — neither may appear in a
    debug response or a log line. The same function stamps JSON log
    records, so ledger rows and log lines join on the hash. Cached:
    the log filter calls this per record and the ledger per billing
    event, always with a small recurring key set."""
    if not tenant:
        tenant = "anon"
    return hashlib.sha256(tenant.encode("utf-8", "surrogatepass")) \
        .hexdigest()[:12]


def _empty_row() -> Dict[str, int]:
    return {cls: 0 for cls in LEDGER_CLASSES}


class GoodputLedger:
    """Per-lane / per-tenant step accounting for one engine (or the
    fleet relay's own events).

    ``record`` is the single write path: it bills one class, one lane,
    one (hashed) tenant, and the independent ``total_steps`` counter in
    one locked step — ``conservation()`` then checks the books actually
    balance rather than asserting a tautology (a future call site that
    pokes a dict directly, or a torn merge, shows up as an imbalance
    instead of silently wrong goodput)."""

    def __init__(self, *, enabled: bool = True, max_tenants: int = 256):
        self.enabled = enabled
        self.max_tenants = max(1, int(max_tenants))
        self._lock = threading.Lock()
        self._totals: Dict[str, int] = _empty_row()
        self._lanes: Dict[str, Dict[str, int]] = {}
        self._tenants: Dict[str, Dict[str, int]] = {}
        self.total_steps = 0

    # ------------------------------------------------------------ writing

    def record(self, cls: str, n: int, *, lane: str = "interactive",
               tenant: Optional[str] = None) -> None:
        """Bill ``n`` steps to one class. Unknown classes are a
        programming error worth failing loudly in tests, not a metric
        label to mint — hence the ValueError."""
        if cls not in self._totals:
            raise ValueError(f"unknown ledger class {cls!r}; "
                             f"valid: {LEDGER_CLASSES}")
        if not self.enabled or n <= 0:
            return
        key = hash_tenant(tenant)
        with self._lock:
            self._totals[cls] += n
            self.total_steps += n
            row = self._lanes.get(lane)
            if row is None:
                row = self._lanes[lane] = _empty_row()
            row[cls] += n
            trow = self._tenants.get(key)
            if trow is None:
                if len(self._tenants) >= self.max_tenants:
                    key = OVERFLOW_TENANT
                    trow = self._tenants.get(key)
                if trow is None:
                    trow = self._tenants[key] = _empty_row()
            trow[cls] += n

    # ------------------------------------------------------------ reading

    @staticmethod
    def _derive(row: Dict[str, int]) -> Dict[str, object]:
        total = sum(row.get(cls, 0) for cls in LEDGER_CLASSES)
        delivered = row.get(CLASS_DELIVERED, 0)
        out: Dict[str, object] = dict(row)
        out["total"] = total
        out["goodput_pct"] = (round(100.0 * delivered / total, 2)
                              if total else None)
        return out

    def snapshot(self) -> Dict[str, object]:
        """Lane-aggregated view (what stats()/metrics consume — no
        tenants here by design)."""
        with self._lock:
            lanes = {lane: dict(row) for lane, row in self._lanes.items()}
            totals = dict(self._totals)
            total_steps = self.total_steps
        return {
            "enabled": self.enabled,
            "classes": totals,
            "lanes": {lane: self._derive(row)
                      for lane, row in sorted(lanes.items())},
            "total_steps": total_steps,
            **{k: v for k, v in self._derive(totals).items()
               if k in ("total", "goodput_pct")},
        }

    def tenant_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Hashed-tenant view — served ONLY by /debug/ledger."""
        with self._lock:
            tenants = {t: dict(row) for t, row in self._tenants.items()}
        return {t: self._derive(row) for t, row in sorted(tenants.items())}

    def conservation(self) -> Dict[str, object]:
        """The invariant the acceptance bar names: delivered + every
        waste class == total accounted steps."""
        with self._lock:
            accounted = sum(self._totals.values())
            total = self.total_steps
        return {
            "total_steps": total,
            "accounted": accounted,
            "balanced": accounted == total,
        }


def merge_snapshots(snaps: List[Dict[str, object]]) -> Dict[str, object]:
    """Sum N engines' lane snapshots into one fleet view (the fleet
    relay's own hedge-loser ledger merges with its replicas')."""
    classes: Dict[str, int] = {cls: 0 for cls in LEDGER_CLASSES}
    lanes: Dict[str, Dict[str, int]] = {}
    total_steps = 0
    enabled = False
    for s in snaps:
        if not s:
            continue
        enabled = enabled or bool(s.get("enabled"))
        total_steps += int(s.get("total_steps", 0))
        for cls, n in (s.get("classes") or {}).items():
            if cls in classes:
                classes[cls] += int(n)
        for lane, row in (s.get("lanes") or {}).items():
            dst = lanes.setdefault(lane, _empty_row())
            for cls in LEDGER_CLASSES:
                dst[cls] += int(row.get(cls, 0))
    out = {
        "enabled": enabled,
        "classes": classes,
        "lanes": {lane: GoodputLedger._derive(row)
                  for lane, row in sorted(lanes.items())},
        "total_steps": total_steps,
    }
    derived = GoodputLedger._derive(classes)
    out["total"] = derived["total"]
    out["goodput_pct"] = derived["goodput_pct"]
    return out
