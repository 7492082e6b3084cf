"""Flight recorder: ring buffer of the last N finished request traces.

The middleware hands every finished serving-path trace here — successes,
sheds, rate-limits, degraded fallbacks, errors — so "request X was slow
at 14:32" is answerable from ``/debug/requests/{id}`` minutes later
without having had debug logging on. Traces are snapshotted to plain
dicts at record time (the Trace object stays with the scheduler thread,
which may append late events the snapshot deliberately excludes).

Memory bound: N timelines of a few KB each — FLIGHT_RECORDER_SIZE=256
keeps it well under a few MB regardless of traffic.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from .trace import Trace


class FlightRecorder:
    def __init__(self, size: int = 256):
        self.size = max(1, int(size))
        self._buf: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.recorded = 0

    def record(self, trace: Trace) -> None:
        snapshot = trace.to_dict()
        with self._lock:
            # A replayed request ID (client retried with the same
            # X-Request-ID) overwrites — last flight wins, and the ring
            # never holds two entries fighting over one lookup key.
            self._buf.pop(trace.request_id, None)
            self._buf[trace.request_id] = snapshot
            while len(self._buf) > self.size:
                self._buf.popitem(last=False)
            self.recorded += 1

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._buf.get(request_id)

    def list(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-first summaries (no spans/events — the index view)."""
        with self._lock:
            entries = list(self._buf.values())
        entries.reverse()
        if limit is not None:
            entries = entries[: max(0, int(limit))]
        return [
            {k: v for k, v in e.items()
             if k not in ("spans", "events", "links")}
            | {"n_spans": len(e.get("spans", ())),
               "n_links": len(e.get("links", ()))}
            for e in entries
        ]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
