"""Step-time sentinel: always-on streaming digests of per-chunk step
time, with online regression detection against a baseline envelope.

Every prior observability layer answers a question about ONE request or
ONE scrape: attribution explains a step, the ledger bills it, the trace
times it. Nothing watched the step itself *over time* — a 20% step-time
regression from a bad checkpoint, a straggling replica, or a
speculative-decode acceptance collapse was invisible until a human ran
a benchmark. This module is the missing signal: both engine schedulers
feed it one sample per decode-chunk cycle (and one per admission
prefill), keyed by ``(phase, bucket)``:

- ``phase`` — ``prefill`` (admission → first-token consume),
  ``decode`` (plain chunk cycle), ``spec_verify`` (speculative
  draft/verify chunk cycle). Closed set: these are Prometheus labels.
- ``bucket`` — the KV bucket the chunk ran at (decode) or the prefill
  bucket covering the prompt (prefill). Bounded by the engine's bucket ladders.

Per key the sentinel keeps a bounded ring of per-step milliseconds
(``window`` samples — memory is O(keys × window) floats), cumulative
counts, and a trailing tokens/sec rate per rung. ``snapshot()`` derives
p50/p95/p99 — the ``step_time_seconds{phase,bucket,quantile}`` gauges —
and judges each digest against its **baseline envelope**:

- a ``PERF_BASELINES`` file (JSON, the numbers of record of the
  deployment's own card) supplies per-phase/per-bucket expected ms, or
- absent a file entry, the digest self-calibrates: the median of its
  first ``min_samples`` samples becomes the baseline (which is what
  lets the whole subsystem — including the regression trigger — run in
  the CPU tests on a toy model, whose μs-scale steps no card's baseline
  could ever judge).

A digest **breaches** when its recent p99 exceeds ``factor ×
baseline`` with at least ``min_samples`` recorded. Breach transitions
count ``trips`` (edge-triggered — a sustained regression is one trip,
not one per scrape). The fleet merges per-replica snapshots with
replica attribution (``merge_snapshots``), which is also what makes a
straggling replica visible: its digests breach while its siblings'
don't. ``canary_vs_stable`` is the weight-rollout gate's optional
step-time verdict (engine/rollout.py, ``ROLLOUT_STEPTIME_GATE``).

Stdlib-only (the ``obs`` rule): ``note()`` runs on the batch scheduler
thread once per chunk cycle.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

#: the closed phase set (Prometheus label values).
PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"
PHASE_SPEC_VERIFY = "spec_verify"
STEP_PHASES = (PHASE_PREFILL, PHASE_DECODE, PHASE_SPEC_VERIFY)

#: default prefill-length buckets used to key prefill samples when the
#: caller has no bucket ladder of its own — label
#: cardinality must be bounded by construction, never by prompt length.
DEFAULT_PREFILL_BUCKETS = (64, 128, 256, 512, 1024)


def prefill_bucket(n: int,
                   buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS) -> int:
    """Smallest bucket covering ``n`` tokens (the last bucket for
    anything larger) — the bounded label a prefill sample is keyed by."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(buckets[-1]) if buckets else int(n)


def load_baselines(path: str) -> Dict[str, Dict[str, float]]:
    """Parse a PERF_BASELINES file into ``{phase: {bucket|'default':
    ms}}``. The file is JSON with a ``step_time_ms`` table (extra keys —
    provenance, notes — are ignored); unknown phases and non-numeric
    entries are startup errors, not silently inert baselines."""
    with open(path) as f:
        data = json.load(f)
    table = data.get("step_time_ms")
    if not isinstance(table, dict) or not table:
        raise ValueError(
            f"PERF_BASELINES {path!r} needs a non-empty 'step_time_ms' "
            f"table ({{phase: {{bucket|'default': ms}}}})")
    out: Dict[str, Dict[str, float]] = {}
    for phase, row in table.items():
        if phase not in STEP_PHASES:
            raise ValueError(
                f"PERF_BASELINES phase {phase!r} is not one of "
                f"{STEP_PHASES}")
        if not isinstance(row, dict):
            raise ValueError(
                f"PERF_BASELINES[{phase!r}] must map bucket|'default' "
                f"to ms, got {type(row).__name__}")
        out[phase] = {}
        for bucket, ms in row.items():
            try:
                ms = float(ms)
            except (TypeError, ValueError):
                raise ValueError(
                    f"PERF_BASELINES[{phase!r}][{bucket!r}] must be a "
                    f"number of ms, got {ms!r}") from None
            if ms <= 0:
                raise ValueError(
                    f"PERF_BASELINES[{phase!r}][{bucket!r}] must be "
                    f"> 0 ms, got {ms}")
            out[phase][str(bucket)] = ms
    return out


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class _Digest:
    """One (phase, bucket) stream: bounded sample ring + counters +
    trailing token rate + baseline/breach state."""

    __slots__ = ("phase", "bucket", "ring", "count", "trips", "breached",
                 "baseline_ms", "baseline_source", "calib", "tokens")

    def __init__(self, phase: str, bucket: int, window: int,
                 file_baseline_ms: Optional[float]):
        self.phase = phase
        self.bucket = int(bucket)
        self.ring: deque = deque(maxlen=window)
        self.count = 0
        self.trips = 0
        self.breached = False
        self.baseline_ms = file_baseline_ms
        self.baseline_source = "file" if file_baseline_ms else None
        self.calib: Optional[List[float]] = (
            None if file_baseline_ms else [])
        self.tokens: deque = deque(maxlen=2048)   # (t, n) rate window


class StepTimeSentinel:
    """Bounded per-(phase, bucket) step-time digests + breach detection
    for one engine instance. Thread-safe: the scheduler thread writes,
    scrape/health threads read."""

    def __init__(self, *, enabled: bool = True, window: int = 256,
                 factor: float = 2.0, min_samples: int = 16,
                 baselines=None, rate_window_secs: float = 60.0,
                 min_breach_ms: float = 5.0):
        self.enabled = bool(enabled)
        self.window = max(8, int(window))
        self.factor = max(1.0, float(factor))
        self.min_samples = max(1, int(min_samples))
        # Absolute breach floor: p99 must ALSO exceed the baseline by
        # this many ms. A μs-scale digest (host-side toy steps, tiny
        # prefills) would otherwise trip on pure scheduler jitter —
        # factor × nothing is still nothing — while any real regression
        # against a ms-scale device baseline (20% of a 23 ms step is
        # already 4.7 ms) clears 5 ms without noticing the floor.
        self.min_breach_ms = max(0.0, float(min_breach_ms))
        self.rate_window_secs = max(1.0, float(rate_window_secs))
        if isinstance(baselines, str) and baselines:
            baselines = load_baselines(baselines)
        self.baselines: Dict[str, Dict[str, float]] = baselines or {}
        self._lock = threading.Lock()
        self._digests: Dict[Tuple[str, int], _Digest] = {}
        self.trips_total = 0

    # ------------------------------------------------------------ writing

    def _file_baseline(self, phase: str, bucket: int) -> Optional[float]:
        row = self.baselines.get(phase)
        if not row:
            return None
        return row.get(str(bucket), row.get("default"))

    def note(self, phase: str, bucket: int, seconds: float, *,
             steps: int = 1, tokens: int = 0,
             now: Optional[float] = None) -> None:
        """Record one sample: ``seconds`` of wall covering ``steps``
        device steps (a chunk cycle passes its token width so the
        stored unit is ms *per step*); ``tokens`` feeds the trailing
        tok/s rate for this rung."""
        if not self.enabled or seconds < 0:
            return
        if phase not in STEP_PHASES:
            raise ValueError(f"unknown step phase {phase!r}; "
                             f"valid: {STEP_PHASES}")
        now = time.monotonic() if now is None else now
        ms = seconds * 1000.0 / max(1, steps)
        key = (phase, int(bucket))
        with self._lock:
            d = self._digests.get(key)
            if d is None:
                d = self._digests[key] = _Digest(
                    phase, bucket, self.window,
                    self._file_baseline(phase, bucket))
            d.ring.append(ms)
            d.count += 1
            if tokens > 0:
                d.tokens.append((now, tokens))
            if d.calib is not None:
                # Self-calibration: the first min_samples samples set
                # the envelope (median — a single cold outlier must not
                # double the baseline).
                d.calib.append(ms)
                if len(d.calib) >= self.min_samples:
                    d.baseline_ms = float(statistics.median(d.calib))
                    d.baseline_source = "calibrated"
                    d.calib = None

    # ------------------------------------------------------------ reading

    def _tok_rate(self, d: _Digest, now: float) -> float:
        horizon = now - self.rate_window_secs
        total = sum(n for t, n in list(d.tokens) if t >= horizon)
        return total / self.rate_window_secs if total else 0.0

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        """Digest table + breach verdicts. Judging happens here (and
        only here), so trips stay edge-triggered no matter how many
        surfaces read the snapshot concurrently."""
        now = time.monotonic() if now is None else now
        digests: Dict[str, dict] = {}
        breaches: List[dict] = []
        with self._lock:
            for (phase, bucket), d in sorted(self._digests.items()):
                vals = sorted(d.ring)
                p50 = _quantile(vals, 0.50)
                p95 = _quantile(vals, 0.95)
                p99 = _quantile(vals, 0.99)
                ready = (d.count >= self.min_samples
                         and d.baseline_ms is not None
                         and d.baseline_ms > 0)
                breach = bool(ready
                              and p99 > self.factor * d.baseline_ms
                              and p99 - d.baseline_ms
                              > self.min_breach_ms)
                if breach and not d.breached:
                    d.trips += 1
                    self.trips_total += 1
                d.breached = breach
                body = {
                    "phase": phase,
                    "bucket": bucket,
                    "count": d.count,
                    "p50_ms": round(p50, 4),
                    "p95_ms": round(p95, 4),
                    "p99_ms": round(p99, 4),
                    "baseline_ms": (round(d.baseline_ms, 4)
                                    if d.baseline_ms else None),
                    "baseline_source": d.baseline_source,
                    "tok_s": round(self._tok_rate(d, now), 2),
                    "breach": breach,
                    "trips": d.trips,
                }
                digests[f"{phase}/{bucket}"] = body
                if breach:
                    breaches.append({
                        "phase": phase, "bucket": bucket,
                        "p99_ms": body["p99_ms"],
                        "baseline_ms": body["baseline_ms"],
                        "factor": self.factor,
                    })
            trips_total = self.trips_total
        return {
            "enabled": self.enabled,
            "factor": self.factor,
            "min_samples": self.min_samples,
            "trips_total": trips_total,
            "digests": digests,
            "breaches": breaches,
        }


def merge_snapshots(snaps: List[Optional[dict]]) -> Dict[str, object]:
    """Fleet rollup of per-replica snapshots (list position = replica
    index). Quantiles don't merge, so the fleet digest per key reports
    the WORST replica's percentiles with counts/rates summed; breaches
    union with replica attribution — which is exactly how a straggler
    shows: its replica index on the breach while siblings stay clean."""
    out: Dict[str, object] = {"enabled": False, "trips_total": 0,
                              "digests": {}, "breaches": [],
                              "replicas": []}
    digests: Dict[str, dict] = {}
    for idx, s in enumerate(snaps):
        if not s:
            continue
        out["enabled"] = out["enabled"] or bool(s.get("enabled"))
        out["trips_total"] += int(s.get("trips_total", 0))
        rep_breaches = []
        for br in (s.get("breaches") or ()):
            tagged = dict(br, replica=idx)
            out["breaches"].append(tagged)
            rep_breaches.append(tagged)
        for key, d in (s.get("digests") or {}).items():
            dst = digests.get(key)
            if dst is None:
                digests[key] = dict(d, worst_replica=idx)
                continue
            dst["count"] = dst.get("count", 0) + d.get("count", 0)
            dst["tok_s"] = round(
                dst.get("tok_s", 0.0) + d.get("tok_s", 0.0), 2)
            dst["trips"] = dst.get("trips", 0) + d.get("trips", 0)
            dst["breach"] = bool(dst.get("breach") or d.get("breach"))
            if d.get("p99_ms", 0.0) > dst.get("p99_ms", 0.0):
                for k in ("p50_ms", "p95_ms", "p99_ms", "baseline_ms",
                          "baseline_source"):
                    dst[k] = d.get(k)
                dst["worst_replica"] = idx
        out["replicas"].append({
            "replica": idx,
            "trips_total": s.get("trips_total", 0),
            "breaches": rep_breaches,
            "digests": s.get("digests") or {},
        })
    out["digests"] = digests
    return out


def canary_vs_stable(canary: Optional[dict],
                     stables: List[Optional[dict]], *,
                     min_samples: int = 8) -> Optional[dict]:
    """Weight-rollout gate input: the canary's worst decode/spec_verify
    p95 ratio against the stable cohort's median p95 on the same
    (phase, bucket) key. None when no key has a meaningful sample on
    both sides — no data must not read as healthy OR as breaching
    (same rule as the burn gate)."""
    if not canary:
        return None
    worst: Optional[dict] = None
    for key, d in (canary.get("digests") or {}).items():
        if d.get("phase") not in (PHASE_DECODE, PHASE_SPEC_VERIFY):
            continue
        if d.get("count", 0) < min_samples or not d.get("p95_ms"):
            continue
        refs = []
        for s in stables:
            sd = ((s or {}).get("digests") or {}).get(key)
            if sd and sd.get("count", 0) >= min_samples \
                    and sd.get("p95_ms"):
                refs.append(float(sd["p95_ms"]))
        if not refs:
            continue
        ref = float(statistics.median(refs))
        if ref <= 0:
            continue
        ratio = float(d["p95_ms"]) / ref
        if worst is None or ratio > worst["ratio"]:
            worst = {"key": key, "canary_p95_ms": float(d["p95_ms"]),
                     "stable_p95_ms": round(ref, 4),
                     "ratio": round(ratio, 4)}
    return worst
