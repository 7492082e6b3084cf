"""Anomaly-triggered incident capture: when the service notices its own
regression, it files the evidence.

The debug surfaces are excellent *during* an incident
— if an operator is already at a terminal with the right curl lines.
What was missing is the 3 a.m. path: a step-time breach or an SLO burn
spike happens, nobody is watching, and by the time a human looks the
flight-recorder ring and the chunk log have rotated past the evidence.
This module closes that loop: a small closed set of **triggers** is
evaluated against the engine's cheap health views, and a firing trigger
assembles a bounded **incident bundle** — flight-recorder snapshot,
chunk-event ring, ledger/SLO/QoS/pool/spec/grammar/sharding health
sections, config fingerprint, weights version — into a ring served by
token-gated ``GET /debug/incidents[/{id}]``.

Triggers (closed set — they are metric labels):

- ``steptime_breach``     — the step-time sentinel's p99 breached its
                            baseline envelope (obs/steptime.py)
- ``slo_fast_burn``       — fast-window error-budget burn ≥
                            ``INCIDENT_BURN_THRESHOLD``
- ``quarantine_spike``    — new terminal quarantines since the last
                            evaluation
- ``grammar_dead_end_spike`` — new grammar dead-end freezes
- ``pool_exhausted``      — KV pool starvation truncated a slot
- ``breaker_open``        — the service circuit breaker opened
- ``host_tier_thrash``    — the two-tier KV pool is churning: pages
                            demoted to host RAM AND onloaded back at
                            matching rates since the last evaluation
                            (the working set no longer fits the device
                            tier — every admission pays tier traffic)

Safety property: **capture can never cascade during the incident it is
observing.** Each trigger has an independent cooldown
(``INCIDENT_COOLDOWN_SECS``); within it further firings are *counted*
(``suppressed``) but assemble nothing — a sustained fault produces a
bounded number of bundles no matter how long it lasts. Spike triggers
judge deltas from the previous evaluation, and the very first
evaluation only baselines (pre-existing quarantines are history, not an
incident).

Log join: every capture stamps its ``incident_id`` into a bounded
module-level window that ``logging_setup.RequestIdFilter`` reads — a
``LOG_FORMAT=json`` line emitted while the incident window is open
carries the same id as the bundle, the exact join pattern the hashed
tenant and request-id stamps already use.

Stdlib-only (the ``obs`` rule). The bundle *collector* is a callable
supplied by the service layer — this module owns trigger policy and
the ring, never HTTP or engine imports.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

TRIGGER_STEPTIME = "steptime_breach"
TRIGGER_BURN = "slo_fast_burn"
TRIGGER_QUARANTINE = "quarantine_spike"
TRIGGER_GRAMMAR = "grammar_dead_end_spike"
TRIGGER_POOL = "pool_exhausted"
TRIGGER_BREAKER = "breaker_open"
TRIGGER_HOST_THRASH = "host_tier_thrash"
TRIGGERS = (TRIGGER_STEPTIME, TRIGGER_BURN, TRIGGER_QUARANTINE,
            TRIGGER_GRAMMAR, TRIGGER_POOL, TRIGGER_BREAKER,
            TRIGGER_HOST_THRASH)

# ---------------------------------------------------------------------------
# Log-join stamp: the active incident window, readable by the log filter
# ---------------------------------------------------------------------------

_stamp_lock = threading.Lock()
_active_stamps: List[Tuple[float, str]] = []   # (expires_mono, incident_id)


def _note_incident(incident_id: str, until: float) -> None:
    with _stamp_lock:
        now = time.monotonic()
        _active_stamps[:] = [(t, i) for t, i in _active_stamps if t > now]
        _active_stamps.append((until, incident_id))
        del _active_stamps[:-8]    # bounded, newest-last


def current_incident_id(now: Optional[float] = None) -> Optional[str]:
    """Newest incident id whose stamp window is still open (None
    otherwise) — what LOG_FORMAT=json lines carry so logs and bundles
    join post-hoc."""
    now = time.monotonic() if now is None else now
    with _stamp_lock:
        live = [(t, i) for t, i in _active_stamps if t > now]
        return live[-1][1] if live else None


def _fast_burn(snap: Optional[dict]) -> Optional[float]:
    """Worst fast-window burn across every (slo, lane) of an
    ``slo_health()`` snapshot (the same derivation the rollout gate
    uses, kept local — obs must not import engine code). None = no
    samples."""
    if not snap:
        return None
    windows = snap.get("windows") or []
    if not windows:
        return None
    fast = windows[0]
    best: Optional[float] = None
    for body in (snap.get("slos") or {}).values():
        for row in (body.get("lanes") or {}).values():
            win = (row.get("windows") or {}).get(fast)
            if win and win.get("total"):
                burn = float(win.get("burn_rate", 0.0))
                best = burn if best is None else max(best, burn)
    return best


class IncidentManager:
    """Trigger evaluation + cooldowns + the bounded incident ring for
    one service instance."""

    def __init__(self, *, ring: int = 8, cooldown_secs: float = 60.0,
                 burn_threshold: float = 2.0,
                 thrash_min_blocks: int = 8,
                 stamp_secs: Optional[float] = None):
        self.ring_size = max(1, int(ring))
        self.cooldown_secs = max(0.0, float(cooldown_secs))
        self.burn_threshold = max(0.0, float(burn_threshold))
        # host_tier_thrash sensitivity: BOTH the demote and onload
        # deltas since the last evaluation must reach this many blocks
        # (0 disables). Churn is the conjunction — a one-way flow is
        # just warmup or drain, not thrash.
        self.thrash_min_blocks = max(0, int(thrash_min_blocks))
        # How long log lines keep joining a fresh bundle; defaults to
        # the cooldown (the window in which no NEW bundle can appear).
        self.stamp_secs = (self.cooldown_secs if stamp_secs is None
                           else max(0.0, float(stamp_secs)))
        self._lock = threading.Lock()
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._last_fire: Dict[str, float] = {}
        self._last_totals: Dict[str, object] = {}
        self.captured: Dict[str, int] = {}
        self.suppressed: Dict[str, int] = {}
        self._seq = 0

    # ---------------------------------------------------------- detection

    def _spike(self, key: str, total: int) -> int:
        """Delta of a cumulative counter since the last evaluation; the
        first evaluation only baselines (0 — pre-existing totals are
        history, not an incident)."""
        prev = self._last_totals.get(key)
        self._last_totals[key] = total
        if prev is None:
            return 0
        return max(0, total - int(prev))

    def detect(self, views: Dict[str, object]) -> List[Tuple[str, dict]]:
        """Evaluate every trigger against one round of health views:
        ``{"steptime", "slo", "kv_pool", "grammar", "breaker",
        "quarantined_total"}`` (any may be None). Returns the firing
        (trigger, detail) pairs — cooldowns are applied later, in
        ``maybe_capture``, so suppressed firings still count."""
        out: List[Tuple[str, dict]] = []
        st = views.get("steptime") or {}
        breaches = st.get("breaches") or []
        if breaches:
            out.append((TRIGGER_STEPTIME, {
                "breaches": list(breaches)[:8],
                "trips_total": st.get("trips_total", 0)}))
        if self.burn_threshold > 0:
            burn = _fast_burn(views.get("slo"))
            if burn is not None and burn >= self.burn_threshold:
                out.append((TRIGGER_BURN, {
                    "fast_burn": round(burn, 4),
                    "threshold": self.burn_threshold}))
        with self._lock:
            n = self._spike("quarantined",
                            int(views.get("quarantined_total") or 0))
            if n > 0:
                out.append((TRIGGER_QUARANTINE, {"new_quarantines": n}))
            g = views.get("grammar") or {}
            dead = sum((g.get("dead_ends_total") or {}).values())
            n = self._spike("dead_ends", int(dead))
            if n > 0:
                out.append((TRIGGER_GRAMMAR, {"new_dead_ends": n}))
            kv = views.get("kv_pool") or {}
            n = self._spike("pool_starved",
                            int(kv.get("starved_slots_total", 0) or 0))
            if n > 0:
                out.append((TRIGGER_POOL, {
                    "new_starved_slots": n,
                    "free_blocks": kv.get("free")}))
            host = kv.get("host_tier") or {}
            dn = self._spike("host_demoted",
                             int(host.get("demoted_total", 0) or 0))
            on = self._spike("host_onloaded",
                             int(host.get("onloaded_total", 0) or 0))
            if (self.thrash_min_blocks > 0
                    and min(dn, on) >= self.thrash_min_blocks):
                out.append((TRIGGER_HOST_THRASH, {
                    "demoted_delta": dn,
                    "onloaded_delta": on,
                    "host_used": host.get("used"),
                    "host_capacity": host.get("capacity"),
                    "threshold": self.thrash_min_blocks}))
            breaker = views.get("breaker")
            prev = self._last_totals.get("breaker")
            self._last_totals["breaker"] = breaker
            if breaker == "open" and prev != "open":
                out.append((TRIGGER_BREAKER, {"breaker": breaker}))
        return out

    # ------------------------------------------------------------ capture

    def evaluate(self, views: Dict[str, object],
                 collect: Callable[[], dict]) -> List[dict]:
        """One evaluation round: detect, then capture whatever passes
        its cooldown. Returns the NEW bundles (empty most rounds)."""
        out = []
        for trigger, detail in self.detect(views):
            bundle = self.maybe_capture(trigger, detail, collect)
            if bundle is not None:
                out.append(bundle)
        return out

    def maybe_capture(self, trigger: str, detail: dict,
                      collect: Callable[[], dict],
                      now: Optional[float] = None) -> Optional[dict]:
        """Assemble one bundle unless ``trigger`` is inside its
        cooldown (then count it suppressed and assemble NOTHING — the
        cooldown is what bounds capture overhead during the very
        incident being observed)."""
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown incident trigger {trigger!r}; "
                             f"valid: {TRIGGERS}")
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last_fire.get(trigger)
            if last is not None and now - last < self.cooldown_secs:
                self.suppressed[trigger] = \
                    self.suppressed.get(trigger, 0) + 1
                return None
            self._last_fire[trigger] = now
            self._seq += 1
            incident_id = f"inc-{int(time.time()) & 0xFFFFFF:06x}-" \
                          f"{self._seq:03d}"
        # Collection runs OUTSIDE the lock: it reads engine health
        # views and the flight recorder, which take their own locks.
        try:
            body = collect() or {}
        except Exception:   # pragma: no cover - defensive
            logger.exception("incident %s: bundle collection failed",
                             incident_id)
            body = {"collection_error": True}
        bundle = {
            "id": incident_id,
            "trigger": trigger,
            "detail": detail,
            "at": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime()) + "Z",
            **body,
        }
        with self._lock:
            self._ring[incident_id] = bundle
            while len(self._ring) > self.ring_size:
                self._ring.popitem(last=False)
            self.captured[trigger] = self.captured.get(trigger, 0) + 1
        _note_incident(incident_id, until=now + self.stamp_secs)
        # The warning itself carries the id through the log filter's
        # stamp, so even text-mode logs name the bundle.
        logger.warning("incident %s captured (trigger=%s): %s",
                       incident_id, trigger, detail)
        return bundle

    # ------------------------------------------------------------ reading

    def get(self, incident_id: str) -> Optional[dict]:
        with self._lock:
            return self._ring.get(incident_id)

    def list(self) -> List[dict]:
        """Newest-first index (summaries only — the detail route serves
        full bundles)."""
        with self._lock:
            entries = list(self._ring.values())
        entries.reverse()
        return [{"id": e["id"], "trigger": e["trigger"],
                 "at": e["at"], "detail": e.get("detail"),
                 "weights_version": e.get("weights_version")}
                for e in entries]

    def snapshot(self) -> dict:
        """Cheap summary for /health and the metrics mirror."""
        with self._lock:
            last = next(reversed(self._ring)) if self._ring else None
            return {
                "ring": len(self._ring),
                "ring_size": self.ring_size,
                "cooldown_secs": self.cooldown_secs,
                "captured_total": dict(self.captured),
                "suppressed_total": dict(self.suppressed),
                "last_incident_id": last,
            }
