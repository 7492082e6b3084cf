"""SLO burn-rate engine: multi-window error-budget accounting per lane.

``SLO_INTERACTIVE_MS`` gave the brownout controller a single p95 trigger;
operators paging on it still had to eyeball raw latency histograms to
answer "are we eating the month's error budget, and how fast?". This
module is the standard SRE answer: each latency sample (TTFT, queue
wait) is judged against its target at record time, and burn rate over
each configured window is

    burn = (breaching / total) / (1 - objective)

— burn 1.0 means "exactly spending budget at the sustainable rate",
above 1.0 the budget is being eaten faster than the objective allows
(the classic multi-window alert pairs a short window, fast detection,
with a long one, low noise). ``budget_remaining`` is the window's
unspent fraction, floored at 0.

Samples are judged at record time and accumulated into coarse TIME
BUCKETS per (slo, lane) — (total, breaching) pairs at a resolution of
one tenth of the shortest window — so memory and the per-probe scan are
bounded by the window geometry, not the request rate: at ANY traffic
level the 1h window really covers an hour (a bounded sample deque would
silently shrink the long window under exactly the high-traffic
conditions burn rates exist for). Window counts include the partial
bucket at the horizon — an error of at most one bucket width, i.e. the
stated resolution. No background thread; stdlib-only (the ``obs``
rule): the record path runs on the batch scheduler thread per
admission/finish.

The snapshot carries raw ``total``/``breaching`` counts per window, so
the fleet can merge N engines' snapshots by summing counts and
recomputing the rates (``merge_snapshots``) — burn rates themselves
don't average.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

#: the SLO metric names (``slo_*`` gauge label set — closed here so
#: cardinality is bounded by construction, like lanes and ledger classes).
SLO_TTFT = "ttft"
SLO_QUEUE_WAIT = "queue_wait"
#: turn-N TTFT for returning sessions: judged ONLY for
#: radix-warm re-admissions — the samples price what the two-tier KV
#: cache is for (a returning agent turn must not pay a cold re-prefill),
#: so cold first turns never dilute the burn rate.
SLO_SESSION_TTFT = "session_ttft"

#: validation cap on configured windows — each window is a label value
#: on every slo_* gauge, so the operator knob must not mint unbounded
#: series any more than a tenant may.
MAX_WINDOWS = 4


def window_label(secs: float) -> str:
    """``300 -> "5m"``, ``3600 -> "1h"`` — the human/metric label."""
    secs = int(secs)
    if secs % 3600 == 0:
        return f"{secs // 3600}h"
    if secs % 60 == 0:
        return f"{secs // 60}m"
    return f"{secs}s"


def parse_slo_windows(spec: str) -> Tuple[int, ...]:
    """``"300,3600"`` → (300, 3600). Ascending, positive, at most
    MAX_WINDOWS — a typo'd spec is a startup error, not a silently
    meaningless burn rate."""
    out: List[int] = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        secs = int(item)
        if secs <= 0:
            raise ValueError(f"SLO_WINDOWS entry must be > 0, got {item!r}")
        out.append(secs)
    if not out:
        raise ValueError("SLO_WINDOWS must name at least one window "
                         "(seconds, e.g. '300,3600')")
    if len(out) > MAX_WINDOWS:
        raise ValueError(
            f"SLO_WINDOWS allows at most {MAX_WINDOWS} windows "
            f"(each is a metric label value), got {len(out)}")
    if sorted(out) != out or len(set(out)) != len(out):
        raise ValueError(
            f"SLO_WINDOWS must be strictly ascending, got {spec!r}")
    return tuple(out)


class SloEngine:
    """Error-budget burn accounting for one engine instance.

    ``targets`` maps slo name → threshold ms (<= 0 disables that slo);
    ``objective`` is the success-rate objective the budget is priced
    from (0.99 → 1% of samples may breach)."""

    def __init__(self, targets: Dict[str, float], *,
                 objective: float = 0.99,
                 windows: Tuple[int, ...] = (300, 3600)):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO objective must be in (0, 1), got {objective}")
        self.targets = {name: float(ms) for name, ms in targets.items()
                        if float(ms) > 0}
        self.objective = float(objective)
        self.windows = tuple(int(w) for w in windows)
        # Bucket geometry: one tenth of the shortest window, so the
        # horizon-truncation error is ≤10% of the fast window; the ring
        # holds longest/width (+ slack) buckets regardless of rate.
        self._bucket_secs = max(1, (self.windows[0] // 10)
                                if self.windows else 1)
        self._max_buckets = ((self.windows[-1] // self._bucket_secs) + 2
                             if self.windows else 1)
        self._lock = threading.Lock()
        # (slo, lane) -> {bucket_index: [total, breaching]}; plus
        # lifetime counters so the metrics delta-mirror can expose a
        # monotone breach total.
        self._buckets: Dict[Tuple[str, str], Dict[int, List[int]]] = {}
        self._totals: Dict[Tuple[str, str], List[int]] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.targets)

    # ------------------------------------------------------------ writing

    def note(self, slo: str, lane: str, value_ms: float,
             now: Optional[float] = None) -> None:
        """Judge one latency sample against its target. Free when the
        slo is disabled (target <= 0)."""
        target = self.targets.get(slo)
        if target is None:
            return
        now = time.monotonic() if now is None else now
        breached = value_ms > target
        key = (slo, lane)
        idx = int(now // self._bucket_secs)
        with self._lock:
            buckets = self._buckets.get(key)
            if buckets is None:
                buckets = self._buckets[key] = {}
                self._totals[key] = [0, 0]
            cell = buckets.get(idx)
            if cell is None:
                cell = buckets[idx] = [0, 0]
                # Amortized prune: drop buckets older than the longest
                # window once the ring overfills (bounds memory at any
                # request rate).
                if len(buckets) > self._max_buckets + 8:
                    floor = idx - self._max_buckets
                    for old in [b for b in buckets if b < floor]:
                        del buckets[old]
            cell[0] += 1
            if breached:
                cell[1] += 1
            tot = self._totals[key]
            tot[0] += 1
            if breached:
                tot[1] += 1

    # ------------------------------------------------------------ reading

    def _window_counts(self, buckets: Dict[int, List[int]], now: float,
                       window: int) -> Tuple[int, int]:
        """Sum buckets inside the window. The bucket containing the
        horizon is counted whole — at most one bucket width (a tenth of
        the fast window) of over-inclusion."""
        floor = int((now - window) // self._bucket_secs)
        total = breaching = 0
        for idx, (n, bad) in buckets.items():
            if idx >= floor:
                total += n
                breaching += bad
        return total, breaching

    def burn_rate(self, total: int, breaching: int) -> float:
        if total <= 0:
            return 0.0
        return (breaching / total) / (1.0 - self.objective)

    def fast_burn(self, slo: str, lane: str,
                  now: Optional[float] = None) -> Optional[float]:
        """Shortest-window burn rate for one (slo, lane) — the brownout
        controller's input signal. None when the slo is disabled or has
        no samples yet (an empty window must not read as 'healthy, raise
        shares' any more than as 'breaching')."""
        if slo not in self.targets or not self.windows:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            buckets = self._buckets.get((slo, lane))
            if not buckets:
                return None
            total, breaching = self._window_counts(buckets, now,
                                                   self.windows[0])
        if total == 0:
            return None
        return self.burn_rate(total, breaching)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        """Full burn-rate view: slo → lane → per-window counts + rates.
        Raw counts ride along so fleet merges recompute rates from sums
        instead of averaging rates."""
        now = time.monotonic() if now is None else now
        out: Dict[str, object] = {
            "enabled": self.enabled,
            "objective": self.objective,
            "windows": [window_label(w) for w in self.windows],
            "slos": {},
        }
        with self._lock:
            keys = sorted(self._buckets)
            data = {k: dict(self._buckets[k]) for k in keys}
            totals = {k: tuple(self._totals[k]) for k in keys}
        for slo, target in sorted(self.targets.items()):
            lanes: Dict[str, object] = {}
            for (s, lane) in keys:
                if s != slo:
                    continue
                wins = {}
                for w in self.windows:
                    total, breaching = self._window_counts(
                        data[(s, lane)], now, w)
                    burn = self.burn_rate(total, breaching)
                    wins[window_label(w)] = {
                        "total": total,
                        "breaching": breaching,
                        "burn_rate": round(burn, 4),
                        "budget_remaining": round(max(0.0, 1.0 - burn), 4),
                    }
                seen, breached = totals[(s, lane)]
                lanes[lane] = {"windows": wins, "samples_total": seen,
                               "breaches_total": breached}
            out["slos"][slo] = {"target_ms": target, "lanes": lanes}
        return out


def merge_snapshots(snaps: List[Dict[str, object]]) -> Dict[str, object]:
    """Sum N engines' snapshots (fleet rollup): per-window counts add,
    burn rates recompute from the sums under the first snapshot's
    objective (replicas share one config)."""
    base = next((s for s in snaps if s and s.get("slos")), None)
    if base is None:
        return {}
    objective = float(base.get("objective", 0.99))
    out: Dict[str, object] = {
        "enabled": any(s.get("enabled") for s in snaps if s),
        "objective": objective,
        "windows": list(base.get("windows", [])),
        "slos": {},
    }
    denom = max(1e-9, 1.0 - objective)
    for s in snaps:
        for slo, body in ((s or {}).get("slos") or {}).items():
            dst = out["slos"].setdefault(
                slo, {"target_ms": body.get("target_ms"), "lanes": {}})
            for lane, row in (body.get("lanes") or {}).items():
                dl = dst["lanes"].setdefault(
                    lane, {"windows": {}, "samples_total": 0,
                           "breaches_total": 0})
                dl["samples_total"] += row.get("samples_total", 0)
                dl["breaches_total"] += row.get("breaches_total", 0)
                for label, win in (row.get("windows") or {}).items():
                    dw = dl["windows"].setdefault(
                        label, {"total": 0, "breaching": 0})
                    dw["total"] += win.get("total", 0)
                    dw["breaching"] += win.get("breaching", 0)
    for body in out["slos"].values():
        for row in body["lanes"].values():
            for win in row["windows"].values():
                burn = ((win["breaching"] / win["total"]) / denom
                        if win["total"] else 0.0)
                win["burn_rate"] = round(burn, 4)
                win["budget_remaining"] = round(max(0.0, 1.0 - burn), 4)
    return out
